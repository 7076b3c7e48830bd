"""glossy_deform_big end to end on the CPU: the port's
render_samples_regen at 16x16, 4 spp, in one chunk of 4, against the JAX
package's, under tests/test_torch_deform_render.py's gates (the image mean
within 1e-3 relative, at least 98% of the pixels within 1e-3). The
scene's mirror sphere has 41,580 triangles on glossy_deform's two-step
path, so both host compiles pack two-level motion tables (936 clusters x
64 in 25 superclusters): the port's closest hits and shadow tests go
through K5's plain version at each ray's time.

The JAX package's answer comes by R7's route (ROADMAP.md section 3): its
CPU dispatch sends a scene with sc_bounds to the packed BVH walk, whose
leaf blocks hold only the shutter-open triangles, so it renders the
sphere as if it did not move. With sc_bounds dropped from its
kg["dscene"] (`r7_kg`), the same dispatch reaches its XLA motion walk
(ops/cluster_intersect.py intersect_clusters with has_motion) over the
same tables, for the closest hit and the shadow test alike. Nothing in
the JAX package changes for that.

The scene has 42,552 prims, so both packages build its BVH with a C++
builder; the JAX package's races (R1), so here, as in
tests/test_torch_textured_render.py, the JAX compile runs under a shim
that puts the port's thread-free builder in its place (`shimmed`).

The accuracy twin of chip_smoke.py's glossy_deform_big phase,
raytracingproject_tpu_torch/data/twin_glossy_deform_big.npz, was made
once on the CPU by the JAX package by R7's route (each mode in its own
process: float64 is a global switch of the JAX package):

    python -m tests.test_torch_deform_two_level_render twin f32 a.npz
    python -m tests.test_torch_deform_two_level_render twin f64 b.npz

`twin` renders 64x64x128, chunk 16, clamp off, in the JAX package's
float32 or float64 compute dtype; the file holds both images under
"f32_jax" and "f64", and under "unstable" and "f32_jax_unstable" the
(row, column) of each pixel whose JAX float32 value moves with the
compilation and that value as `pixel f32 X Y` prints it (below). The mean chip_smoke.py holds the full-width renders
to (JAX_MEAN_GLOSSY_DEFORM_BIG_256):

    python -m tests.test_torch_deform_two_level_render mean 256 64 32

prints the image mean at W x W x SPP in chunks of CHUNK with the default
clamp, rendered in strips of 64 rows; `mean 256 64 32 Y0 Y1` renders
rows Y0 to Y1 only and prints their mean (the mean of equal strips is
the image's: run them side by side).

    python -m tests.test_torch_deform_two_level_render pixel f32|f64 X Y

renders pixel (X, Y) of the twin's 64x64x128 frame alone, one lane and
one sample a call, and prints its mean and the samples that differ from
the twin's: the JAX package's own value of a pixel whose paths graze an
edge moves with the compilation (pixel (3, 12): one sample of 128 meets
the light's back face in the whole-frame renders and passes its edge
here), which chip_smoke.py's accuracy phase takes into account (its
`unstable` pixels)."""

import contextlib
import sys

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] in ("twin", "pixel") and sys.argv[2] == "f64":
        # before the JAX package's modules are imported: some read the
        # compute dtype at import
        from raytracingproject_tpu.utils import precision
        precision.set_f64()

import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import native as jnative
from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.models import mesh as jmesh
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu_torch import native
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
W = 16
SPP = 4


def port_builder(lo, hi, max_leaf_size=4):
    """The shim: the port's C++ builder in the JAX package's place."""
    return native.build_bvh_native(lo, hi, max_leaf_size)


@contextlib.contextmanager
def shimmed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_bvh_native", port_builder)
        yield


def jax_scene(width, height, spp):
    """The JAX package's twin of the port's glossy_deform_big_scene, from
    its own calls. Compile it under `shimmed`."""
    js = jex.cornell_box(width, height, spp, spheres="glossy")
    obj = next(o for o in js.objects if o.name == "sphere1")
    mesh = jmesh.make_sphere_mesh((185, 170, 90), 90, 0, name="sphere1",
                                  **tex.BIG_SPHERE)
    mesh.set("smooth", np.ones(mesh.num_triangles, bool))
    mesh.used_shaders = obj.geometry.used_shaders
    obj.geometry = mesh
    mesh.attribute_set("std_motion_vertex_position", "vertex",
                       tex.glossy_deform_path(mesh.verts_array))
    return js


def r7_kg(kg):
    """R7's route: the JAX kernel globals without sc_bounds, so that its
    CPU dispatch walks the motion rows (intersect_clusters with
    has_motion) in place of the packed BVH's shutter-open triangles."""
    ds = {k: v for k, v in kg["dscene"].items() if k != "sc_bounds"}
    return {**kg, "dscene": ds}


def jax_render(width, spp, chunk, clamp_off=False, rows=None, y_range=None):
    """The JAX package's image of the scene by R7's route at width x
    width x spp, in chunks of `chunk` samples accumulated in float64, the
    film in strips of `rows` rows (a lane's samples depend on its pixel
    alone); with y_range (y0, y1) only those rows, (y1 - y0, width, 3)."""
    js = jax_scene(width, width, spp)
    if clamp_off:
        js.integrator.set("sample_clamp_indirect", 0.0)
    with shimmed():
        js.device_update()
    kg = r7_kg(js.make_kernel_globals())
    ya, yb = y_range or (0, width)
    rows = min(rows or width, yb - ya)
    fn = jax.jit(lambda a, b, c, s: jinteg.render_samples_regen(
        kg, a, b, c, s, chunk))
    img = np.zeros((yb - ya, width, 3))
    for y0 in range(ya, yb, rows):
        yy, xx = np.mgrid[y0:y0 + rows, 0:width]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        acc = sum(np.asarray(fn(px, py, py * width + px, jnp.uint32(s))[0],
                             np.float64) for s in range(0, spp, chunk))
        img[y0 - ya:y0 - ya + rows] = acc.reshape(rows, width, 3) / spp
    return img


def test_render_matches_jax():
    ts = tex.glossy_deform_big_scene(W, W, SPP)
    ts.device_update()
    kg = ts.make_kernel_globals("cpu")
    px, py, pidx = pixel_wavefront(W, W, 1, "cpu")
    before = k5.launches
    L, A = integ.render_samples_regen(kg, px, py, pidx, 0, SPP)
    assert k5.launches == before  # CPU: the plain version
    assert torch.equal(A, torch.full_like(A, float(SPP)))
    got = (L / SPP).numpy().reshape(W, W, 3)
    ref = jax_render(W, SPP, SPP)
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert abs(got.mean() / ref.mean() - 1.0) <= 1e-3
    assert (np.abs(got - ref).max(-1) <= 1e-3).mean() >= 0.98


def jax_pixel(x, y, width=64, spp=128):
    """The JAX package's samples of pixel (x, y) of the twin's frame
    (clamp off) by R7's route, one lane and one sample a call: (spp, 3)."""
    js = jax_scene(width, width, spp)
    js.integrator.set("sample_clamp_indirect", 0.0)
    with shimmed():
        js.device_update()
    kg = r7_kg(js.make_kernel_globals())
    fn = jax.jit(lambda a, b, c, s: jinteg.render_samples_regen(
        kg, a, b, c, s, 1))
    px, py = jnp.asarray([x], jnp.int32), jnp.asarray([y], jnp.int32)
    return np.stack([np.asarray(fn(px, py, py * width + px, jnp.uint32(s))[0],
                                np.float64)[0] for s in range(spp)])


if __name__ == "__main__":
    if sys.argv[1] == "pixel":
        x, y = int(sys.argv[3]), int(sys.argv[4])
        smp = jax_pixel(x, y)
        twin = np.load("raytracingproject_tpu_torch/data/"
                       "twin_glossy_deform_big.npz")
        key = {"f32": "f32_jax", "f64": "f64"}[sys.argv[2]]
        print("pixel", x, y, sys.argv[2], "one sample a call: mean",
              repr(smp.mean(0).tolist()), "; whole-frame twin",
              repr(twin[key][y, x].tolist()))
    elif sys.argv[1] == "twin":
        img = jax_render(64, 128, 16, clamp_off=True)
        key = {"f32": "f32_jax", "f64": "f64"}[sys.argv[2]]
        np.savez_compressed(sys.argv[3], **{key: img})
        print("glossy_deform_big", sys.argv[2], "mean",
              repr(float(img.mean())))
    else:
        width, spp, chunk = (int(x) for x in sys.argv[2:5])
        y_range = tuple(int(x) for x in sys.argv[5:7]) or None
        img = jax_render(width, spp, chunk, rows=64, y_range=y_range)
        print("mean glossy_deform_big", width, spp, chunk, y_range or "",
              repr(float(img.mean())))
