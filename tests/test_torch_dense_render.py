"""The dense path as a whole, on the CPU (the sweeps' plain versions):

- cornell_diffuse (cornell_box with its two boxes, 36 prims, use_brute)
  16x16, 4 spp, clamp off, against the JAX package's render of the same
  scene through its own dispatch (intersect_brute, shadow_blocked_brute):
  >= 99% of the pixels within 1e-3 and the mean within 0.5%, as
  tests/test_torch_render.py holds the glossy box;
- volume_sss under the host compile's own dispatch (use_brute: the dense
  closest hit and intersect_brute_occlusion for both volume-NEE sweeps)
  16x16, 4 spp against the JAX package's render under the same dispatch:
  mean within 2e-3 + 1%, pixels atol 0.02 / rtol 0.05, as
  tests/test_torch_volume_render.py holds the pinned dispatch (the
  frameworks round exp, log, sin and cos differently, which flips rare
  scatter and roulette decisions);
- the same dense render against the port's own pinned render (K4's and
  K3's plain versions): one estimator and one arithmetic, so the images
  differ only where a tie picks another prim;
- the dispatch itself: which wrapper each kg selects, through the render
  entry points.

`jax_mean` is also how chip_smoke.py's cornell_diffuse reference was made,
once, on the CPU (about 5 minutes):

    python -m tests.test_torch_dense_render mean 512 64 32

prints the image mean of the JAX package's own 512x512, 64-spp render of
cornell_box() in chunks of 32 with the default clamp (JAX_MEAN_CORNELL_512
in chip_smoke.py)."""

import functools
import sys

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu_torch.app import cli
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.ops import dense_sweep
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session.session import (
    pixel_wavefront, render)

torch.set_num_threads(1)
W = H = 16
SPP = 4


def _scene(ex, name):
    if name == "cornell":
        s = ex.cornell_box(W, H, spp=SPP)
        s.integrator.set("sample_clamp_indirect", 0.0)
    else:
        s = ex.volume_sss_scene(W, H, spp=SPP)
    s.device_update()
    return s


@functools.lru_cache(maxsize=None)
def _port_image(name, pinned=False):
    kg = _scene(tex, name).make_kernel_globals("cpu")
    assert kg["use_brute"]
    if pinned:
        kg.update(tex.VOLUME_SSS_DISPATCH)
    px, py, pidx = pixel_wavefront(W, H, 1, "cpu")
    L, A = integ.render_samples_regen(kg, px, py, pidx, 0, SPP)
    assert torch.equal(A, torch.full_like(A, float(SPP)))
    return (L / SPP).numpy().reshape(H, W, 3)


@functools.lru_cache(maxsize=None)
def _jax_image(name):
    kg = _scene(jex, name).make_kernel_globals()
    assert kg["use_brute"]
    yy, xx = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    L, _A = jax.jit(lambda a, b, c: jinteg.render_samples_regen(
        kg, a, b, c, 0, SPP))(px, py, py * W + px)
    return np.asarray(L).reshape(H, W, 3) / SPP


def jax_mean(width, spp, chunk, rows=128):
    """Image mean of the JAX package's cornell_diffuse render at width x
    width x spp, chunks of `chunk` samples, accumulated in float64; the
    film goes through in strips of `rows` rows (a lane's samples depend
    on its pixel alone)."""
    js = jex.cornell_box(width, width, spp=spp)
    js.device_update()
    kg = js.make_kernel_globals()
    fn = jax.jit(lambda a, b, c, s: jinteg.render_samples_regen(
        kg, a, b, c, s, chunk))
    total = 0.0
    for y0 in range(0, width, rows):
        yy, xx = np.mgrid[y0:min(y0 + rows, width), 0:width]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        for i in range(spp // chunk):
            L, _A = fn(px, py, py * width + px, jnp.uint32(i * chunk))
            total += float(np.asarray(L, np.float64).sum())
    return total / (width * width * 3 * spp)


def test_cornell_diffuse_matches_jax():
    got, ref = _port_image("cornell"), _jax_image("cornell")
    assert np.isfinite(got).all() and got.mean() > 0.05
    d = np.abs(got - ref).max(-1)
    assert (d <= 1e-3).mean() >= 0.99, (d > 1e-3).sum()
    assert abs(got.mean() / ref.mean() - 1.0) <= 5e-3


def test_volume_sss_dense_matches_jax():
    got, ref = _port_image("volume_sss"), _jax_image("volume_sss")
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert abs(got.mean() - ref.mean()) < 2e-3 + 0.01 * ref.mean()
    np.testing.assert_allclose(got, ref, atol=0.02, rtol=0.05)


def test_volume_sss_dense_matches_the_pinned_dispatch():
    dense = _port_image("volume_sss")
    pinned = _port_image("volume_sss", pinned=True)
    assert abs(dense.mean() / pinned.mean() - 1.0) <= 1e-3
    d = np.abs(dense - pinned).max(-1)
    assert (d <= 1e-3).mean() >= 0.99, (d > 1e-3).sum()


@pytest.mark.parametrize("spec,modes", [
    ("example:cornell", {"closest", "any"}),
    ("example:volume_sss:dense", {"closest", "dual"}),
    ("example:volume_sss", set()),
])
def test_dispatch_reaches_the_dense_wrappers(monkeypatch, spec, modes):
    """Through the CLI's scene loader and session.render: cornell calls
    K1's closest and any-hit wrappers, volume_sss:dense the closest and
    dual ones, the pinned volume_sss none of them."""
    called = set()
    for mode, fn in (("closest", "intersect_brute_sweep"),
                     ("any", "shadow_blocked_sweep"),
                     ("dual", "occlusion_sweep")):
        orig = getattr(dense_sweep, fn)

        def spy(*a, _orig=orig, _mode=mode, **kw):
            called.add(_mode)
            return _orig(*a, **kw)

        monkeypatch.setattr(dense_sweep, fn, spy)
    scene, flags = cli.load_scene(spec)
    scene.camera.set("width", 6)
    scene.camera.set("height", 6)
    scene.device_update()
    kg = {**scene.make_kernel_globals("cpu"), **flags}
    img = render(scene, 1, chunk=1, device="cpu", kg=kg)
    assert img.shape == (6, 6, 3) and np.isfinite(img).all()
    assert called == modes


def test_cli_renders_the_dense_examples(tmp_path):
    for spec in ("example:cornell", "example:volume_sss:dense"):
        args = cli.build_parser().parse_args(
            [spec, "--device", "cpu", "--width", "8", "--height", "8",
             "--samples", "2", "--chunk", "2"])
        img, st = cli.run(args)
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
        assert img.mean() > 0.02 and st["samples"] == 2
    with pytest.raises(SystemExit):
        cli.load_scene("example:volume_sss:sparse")


def test_profile_render_knows_the_dense_scenes():
    from raytracingproject_tpu_torch.app import profile_render
    out = profile_render.profile("cornell", width=8, spp=1, profile_spp=1,
                                 device="cpu")
    assert out["scene"] == "example:cornell" and out["lanes"] == 64
    assert out["device_idle_share"] is None
    assert {"volume_sss_dense", "big_instanced_onehot2"} \
        <= set(profile_render.SCENES)


if __name__ == "__main__":
    width, spp, chunk = (int(x) for x in sys.argv[2:5])
    print("mean", width, spp, chunk, repr(jax_mean(width, spp, chunk)))
