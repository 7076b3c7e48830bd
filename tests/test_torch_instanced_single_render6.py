"""instanced_scene(grid=6) end to end on the CPU: the port's
render_samples_regen at 16x16, 4 spp, in one chunk of 4 (closest hits
through K4's plain version and shadow tests through K3's, both with
instance rows) against the JAX package's, under
tests/test_torch_instanced_render.py's gates: the image mean within 1e-3
relative, and at least 98% of the pixels within 1e-3 (largest RGB
difference). The two renders draw the same samples; shading rounds sin,
cos and sqrt an ulp or two apart in the two frameworks.

The accuracy twin of chip_smoke.py's grid=6 phase,
raytracingproject_tpu_torch/data/twin_instanced_grid6.npz, was made once
on the CPU by the JAX package (each mode in its own process: float64 is
a global switch of the JAX package):

    python -m tests.test_torch_instanced_single_render6 twin f32 a.npz
    python -m tests.test_torch_instanced_single_render6 twin f64 b.npz
    python -m tests.test_torch_instanced_single_render6 twin f32 a.npz
    python -m tests.test_torch_instanced_single_render6 twin f64 b.npz

`twin` renders 64x64x128, chunk 16, clamp off, in the JAX package's
float32 or float64 compute dtype (tools/rmse_twin.py's method); the
file holds both images under "f32_jax" and "f64". The means
chip_smoke.py holds its full-width renders to (JAX_MEAN_GRID6_256,
JAX_MEAN_GRID5N15_256) were made the same way:

    python -m tests.test_torch_instanced_single_render6 mean 256 64 32 6 12
    python -m tests.test_torch_instanced_single_render6 mean 256 64 32 5 15

print the image mean of instanced_scene(grid, nlat) at W x W x SPP in
chunks of CHUNK with the default clamp, rendered in strips of 64 rows."""

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
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
from raytracingproject_tpu_torch.ops import tile_walk as k4
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
W = 16
SPP = 4


def jax_render(width, spp, chunk, clamp_off=False, rows=None, **scene):
    """The JAX package's instanced_scene(**scene) image at width x width
    x spp, in chunks of `chunk` samples accumulated in float64, the film
    in strips of `rows` rows (a lane's samples depend on its pixel
    alone)."""
    js = jex.instanced_scene(width, width, spp=spp, **scene)
    if clamp_off:
        js.integrator.set("sample_clamp_indirect", 0.0)
    js.device_update()
    kg = js.make_kernel_globals()
    rows = rows or width
    fn = jax.jit(lambda a, b, c, s: jinteg.render_samples_regen(
        kg, a, b, c, s, chunk))
    img = np.zeros((width, width, 3))
    for y0 in range(0, width, rows):
        yy, xx = np.mgrid[y0:y0 + rows, 0:width]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        acc = sum(np.asarray(fn(px, py, py * width + px, jnp.uint32(s))[0],
                             np.float64) for s in range(0, spp, chunk))
        img[y0:y0 + rows] = acc.reshape(rows, width, 3) / spp
    return img


def port_render(kg, width=W, spp=SPP):
    """The port's image of kg at width x width x spp in one chunk."""
    px, py, pidx = pixel_wavefront(width, width, 1, "cpu")
    L, A = integ.render_samples_regen(kg, px, py, pidx, 0, spp)
    assert torch.equal(A, torch.full_like(A, float(spp)))
    return (L / spp).numpy().reshape(width, width, 3)


def assert_render_gates(got, ref):
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert abs(got.mean() / ref.mean() - 1.0) <= 1e-3
    assert (np.abs(got - ref).max(-1) <= 1e-3).mean() >= 0.98


@functools.lru_cache(maxsize=None)
def jax_image(**scene):
    return jax_render(W, SPP, SPP, **scene)


def test_grid6_render_matches_jax():
    from tests.test_torch_instanced_single import port_kg
    kg = port_kg("grid6")
    before = (k4.launches, k3.launches)
    got = port_render(kg)
    assert (k4.launches, k3.launches) == before   # CPU: the plain versions
    assert_render_gates(got, jax_image(grid=6))


if __name__ == "__main__":
    if sys.argv[1] == "twin":
        img = jax_render(64, 128, 16, clamp_off=True, grid=6)
        key = {"f32": "f32_jax", "f64": "f64"}[sys.argv[2]]
        np.savez_compressed(sys.argv[3], **{key: img})
        print(sys.argv[2], "mean", repr(float(img.mean())))
    else:
        width, spp, chunk, grid, nlat = (int(x) for x in sys.argv[2:7])
        img = jax_render(width, spp, chunk, rows=64, grid=grid, nlat=nlat)
        print("mean", width, spp, chunk, grid, nlat, repr(float(img.mean())))
