"""The big_instanced slice as a whole: instanced_scene(grid=8) rendered
at 16x16, 4 spp, chunk 4 on the CPU by the port (K5's plain version: the
plain walk with instance rows, for every closest hit and every shadow
test) against the JAX package's render_samples_regen (off the TPU it
walks its packed BVH, the JAX package's own twin of K5), plus the
two-level dispatch rules.

The two renders draw the same samples and find the same hits; shading
(the image texture, the box-filtered checker, the distant sun, the sky)
and the light sample round sin, cos and sqrt an ulp or two apart. Gates:
the image mean within 1e-3 relative, and at least 98% of the pixels
within 1e-3 (largest RGB difference). Measured on this scene (CPU, both
packages): mean relative difference 4.8e-7, largest pixel difference
3.6e-5.

`jax_render` is also how chip_smoke.py's big_instanced references were
made, once, on the CPU (each mode in its own process: float64 is a
global switch of the JAX package):

    python -m tests.test_torch_instanced_render twin f32 a.npz
    python -m tests.test_torch_instanced_render twin f64 b.npz
    python -m tests.test_torch_instanced_render mean 256 16 8

`twin` renders 64x64x128, chunk 16, clamp off, with the JAX package's
float32 or float64 compute dtype (tools/rmse_twin.py's method);
raytracingproject_tpu_torch/data/twin_big_instanced.npz holds both
outputs' images under their keys, "f32_jax" and "f64". `mean` prints the
image mean of a W x W x SPP render with the default clamp
(JAX_MEAN_BIG_256 in chip_smoke.py)."""

import functools
import sys

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:3] == ["twin", "f64"]:
        # before the JAX package's modules are imported: some read the
        # compute dtype at import
        from raytracingproject_tpu.utils import precision
        precision.set_f64()

import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models.scene import kg_from_jax
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
W = H = 16
SPP = 4


@pytest.fixture(scope="module")
def tkg():
    ts = tex.instanced_scene(W, H, spp=SPP, grid=8)
    ts.device_update()
    return ts.make_kernel_globals("cpu")


def jax_render(width, spp, chunk, clamp_off=False):
    """The JAX package's big_instanced image at width x width x spp, in
    chunks of `chunk` samples accumulated in float64."""
    js = jex.instanced_scene(width, width, spp=spp, grid=8)
    if clamp_off:
        js.integrator.set("sample_clamp_indirect", 0.0)
    js.device_update()
    kg = js.make_kernel_globals()
    yy, xx = np.mgrid[0:width, 0:width]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    fn = jax.jit(lambda a, b, c, s: jinteg.render_samples_regen(
        kg, a, b, c, s, chunk))
    acc = 0.0
    for i in range(spp // chunk):
        L, _A = fn(px, py, py * width + px, jnp.uint32(i * chunk))
        acc = acc + np.asarray(L, np.float64)
    return acc.reshape(width, width, 3) / spp


@functools.lru_cache(maxsize=None)
def _jax_image():
    return jax_render(W, SPP, SPP)


def test_render_matches_jax(tkg):
    px, py, pidx = pixel_wavefront(W, H, 1, "cpu")
    before = k5.launches
    L, A = integ.render_samples_regen(tkg, px, py, pidx, 0, SPP)
    assert k5.launches == before   # CPU tensors: the plain version
    assert torch.equal(A, torch.full_like(A, float(SPP)))
    got = (L / SPP).numpy().reshape(H, W, 3)
    ref = _jax_image()
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert abs(got.mean() / ref.mean() - 1.0) <= 1e-3
    assert (np.abs(got - ref).max(-1) <= 1e-3).mean() >= 0.98


def test_kg_from_jax_renders_the_same(tkg):
    js = jex.instanced_scene(W, H, spp=SPP, grid=8)
    js.device_update()
    ckg = kg_from_jax(js.make_kernel_globals(device_put=False), "cpu")
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    a = integ.render_samples_regen(ckg, px, py, pidx, 0, 2)[0]
    b = integ.render_samples_regen(tkg, px, py, pidx, 0, 2)[0]
    assert torch.equal(a, b)


def _meta_rays(n=4):
    o = torch.empty((n, 3), device="meta")
    t = torch.empty(n, device="meta")
    return o, t, torch.empty(n, dtype=torch.int32, device="meta")


def test_two_level_dispatch(tkg):
    """Two-level tables go to K5 (on meta tensors, which are not CPU
    tensors, its wrapper refuses them: they are not CUDA tensors); with
    pallas_clusters2 off the card refuses the plain walk; K6
    (pallas_onehot2) is not ported; K3 never takes two-level tables."""
    o, t, vis = _meta_rays()
    with pytest.raises(ValueError, match="CUDA tensor"):
        integ._scene_intersect_tris(tkg, o, o, t, t, vis)
    with pytest.raises(NotImplementedError, match="K5"):
        integ._scene_intersect_tris({**tkg, "pallas_clusters2": False}, o, o,
                                    t, t, vis)
    with pytest.raises(NotImplementedError, match="K6"):
        integ._scene_intersect_tris({**tkg, "pallas_onehot2": True}, o, o,
                                    t, t, vis)
    assert not integ._use_occlusion_walk(tkg)
    assert not integ._use_occlusion_walk({**tkg, "pallas_occlusion": True})


def test_plain_walk_takes_the_cpu_path(tkg):
    """With pallas_clusters2 off, CPU tensors take the plain walk: the
    same hits as the K5 wrapper's CPU path."""
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    a = integ.render_samples_regen(tkg, px, py, pidx, 0, 1)[0]
    b = integ.render_samples_regen({**tkg, "pallas_clusters2": False}, px,
                                   py, pidx, 0, 1)[0]
    assert torch.equal(a, b)


if __name__ == "__main__":
    if sys.argv[1] == "twin":
        img = jax_render(64, 128, 16, clamp_off=True)
        key = {"f32": "f32_jax", "f64": "f64"}[sys.argv[2]]
        np.savez_compressed(sys.argv[3], **{key: img})
        print(sys.argv[2], "mean", repr(float(img.mean())))
    else:
        width, spp, chunk = (int(x) for x in sys.argv[2:5])
        print("mean", width, spp, chunk,
              repr(float(jax_render(width, spp, chunk).mean())))
