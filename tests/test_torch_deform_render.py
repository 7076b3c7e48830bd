"""The two deforming scenes end to end on the CPU: the port's
render_samples_regen at 16x16, 4 spp, in one chunk of 4, against the JAX
package's, under tests/test_torch_instanced_render.py's gates (the image
mean within 1e-3 relative, at least 98% of the pixels within 1e-3,
largest RGB difference): glossy_deform (motion cluster rows: the closest
hits through K2's plain version, the shadow tests through K3's, each at
the ray's time) and cornell_deform (a three-step path: K1's plain deform
sweeps). The two renders draw the same samples and times; shading rounds
sin, cos and sqrt an ulp or two apart, and XLA:CPU contracts the
multiply-adds of the time lerp.

The JAX twin of each scene is built here from the JAX package's own
calls (`cornell_box`, `Mesh.attribute_set`) with the port's path
functions (numpy only): `jax_scene`.

The accuracy twins of chip_smoke.py's deform phase,
raytracingproject_tpu_torch/data/twin_{glossy,cornell}_deform.npz, were
made once on the CPU by the JAX package (each mode in its own process:
float64 is a global switch of the JAX package):

    python -m tests.test_torch_deform_render twin glossy f32 a.npz
    python -m tests.test_torch_deform_render twin glossy f64 b.npz

`twin` renders 64x64x128, chunk 16, clamp off, in the JAX package's
float32 or float64 compute dtype; the file holds both images under
"f32_jax" and "f64". The means chip_smoke.py holds the full-width
renders to (JAX_MEAN_GLOSSY_DEFORM_256, JAX_MEAN_CORNELL_DEFORM_256):

    python -m tests.test_torch_deform_render mean glossy 256 64 32
    python -m tests.test_torch_deform_render mean cornell 256 64 32

print the image mean at W x W x SPP in chunks of CHUNK with the default
clamp, rendered in strips of 64 rows."""

import functools
import sys

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "twin" and sys.argv[3] == "f64":
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
from raytracingproject_tpu_torch.ops import cluster_walk as k2
from raytracingproject_tpu_torch.ops import dense_sweep as k1
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
W = 16
SPP = 4
PORT_SCENES = {"glossy": tex.glossy_deform_scene,
               "cornell": tex.cornell_deform_scene}


def jax_scene(name, width, height, spp):
    """The JAX package's twin of the port's glossy_deform_scene /
    cornell_deform_scene."""
    if name == "glossy":
        js = jex.cornell_box(width, height, spp, spheres="glossy")
        mesh, path = tex.find_mesh(js, "sphere1"), tex.glossy_deform_path
    else:
        js = jex.cornell_box(width, height, spp)
        mesh, path = tex.find_mesh(js, "short_box"), tex.cornell_deform_path
    mesh.attribute_set("std_motion_vertex_position", "vertex",
                       path(mesh.verts_array))
    return js


def jax_render(name, width, spp, chunk, clamp_off=False, rows=None):
    """The JAX package's image of the scene at width x width x spp, in
    chunks of `chunk` samples accumulated in float64, the film in strips
    of `rows` rows (a lane's samples depend on its pixel alone)."""
    js = jax_scene(name, width, width, spp)
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


def port_render(name):
    ts = PORT_SCENES[name](W, W, SPP)
    ts.device_update()
    kg = ts.make_kernel_globals("cpu")
    px, py, pidx = pixel_wavefront(W, W, 1, "cpu")
    L, A = integ.render_samples_regen(kg, px, py, pidx, 0, SPP)
    assert torch.equal(A, torch.full_like(A, float(SPP)))
    return (L / SPP).numpy().reshape(W, W, 3)


@pytest.mark.parametrize("name", sorted(PORT_SCENES))
def test_render_matches_jax(name):
    before = (k1.launches["closest"], k2.launches, k3.launches)
    got = port_render(name)
    # CPU: the plain versions, no launch
    assert (k1.launches["closest"], k2.launches, k3.launches) == before
    ref = jax_render(name, W, SPP, SPP)
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert abs(got.mean() / ref.mean() - 1.0) <= 1e-3
    assert (np.abs(got - ref).max(-1) <= 1e-3).mean() >= 0.98


if __name__ == "__main__":
    if sys.argv[1] == "twin":
        img = jax_render(sys.argv[2], 64, 128, 16, clamp_off=True)
        key = {"f32": "f32_jax", "f64": "f64"}[sys.argv[3]]
        np.savez_compressed(sys.argv[4], **{key: img})
        print(sys.argv[2], sys.argv[3], "mean", repr(float(img.mean())))
    else:
        width, spp, chunk = (int(x) for x in sys.argv[3:6])
        img = jax_render(sys.argv[2], width, spp, chunk, rows=64)
        print("mean", sys.argv[2], width, spp, chunk, repr(float(img.mean())))
