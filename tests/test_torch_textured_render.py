"""The textured_instanced slice as a whole, on the CPU (K2's and K3's plain
versions; K4's at grid=5):

- the port's host compile of instanced_scene at grid=4 (the
  textured_instanced configuration: 16 x 528 + 2 = 8,450 prims, under
  AUTO_FLATTEN_MAX_PRIMS, so compiled flattened, 385 clusters x 30
  triangles) and at grid=5 (13,202 prims, 599 clusters x 32) against the
  JAX package's: array-equal tables (rotated smooth spheres with corner
  uvs, flattened to world space with their normals), filter table and
  statics;
- the dispatch: grid=4 takes the per-lane cluster walk (K2) for closest
  hits and the occlusion walk (K3) for shadow rays, grid=5's 599
  clusters the tile-shared walk (K4, past K2's 512) and K3;
- the port's render_samples_regen at 16x16, 4 spp, in one chunk, against
  the JAX package's, under tests/test_torch_instanced_render.py's
  criteria (the mean within 1e-3 relative, >= 98% of the pixels within
  1e-3): shading rounds sin, cos and sqrt an ulp or two apart in the two
  frameworks.

Both packages build these scenes' BVHs with a C++ builder (2,048 prims and
more). The JAX package's recurses on a second thread near the top of a
tree this size and numbers nodes and prims differently from build to
build (8 of its compiles of this scene gave 4 different table sets), so
in this file only, pytest's monkeypatch replaces
raytracingproject_tpu.native.build_bvh_native with a shim that returns
the port's builder's arrays. tests/test_torch_bvh_native.py holds that
builder to the JAX package's (equal wherever the JAX builder takes no
thread, equal after depth-first relabelling where it does). No file of
the JAX package changes.

The JAX references of chip_smoke.py's textured_instanced phases were made
once on the CPU with the same shim:

    python -m tests.test_torch_textured_render mean 256 64 32 4
    python -m tests.test_torch_textured_render mean 128 8 8 5

print the image mean of the JAX package's own render of instanced_scene
(grid 4: 256x256, 64 spp, chunks of 32; grid 5: 128x128, 8 spp, chunks
of 8) with the default clamp (JAX_MEAN_TEX_256, JAX_MEAN_TEX5_128), and

    python -m tests.test_torch_textured_render wavefronts

renders the 64x64x128 twin scene (clamp off) in float64 as
tools/rmse_twin.py does (utils/precision.py set_f64), through
render_samples_regen over the whole frame and through render_samples a
row at a time, and prints how far the two are apart (a float32 record
that fed the float64 render would make its value depend on the
wavefront's shape, as the dof camera's motion record did) and how far
each is from the twins' textured_instanced entries: artifacts/
twin_f64_r04.npz, the reference of chip_smoke.py's accuracy phase, and
artifacts/twin_f64.npz, whose entry for this scene predates the
box-filtered checker."""

import sys

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "wavefronts":
        from raytracingproject_tpu.utils import precision
        precision.set_f64()

import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import native as jnative
from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu_torch import native
from raytracingproject_tpu_torch.app import cli
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models.scene import (
    KG_ARRAYS, KG_DENSE, kg_from_jax)
from raytracingproject_tpu_torch.ops import cluster_walk as k2
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
W = 16
SPP = 4
STATICS = ("sc_gmax", "cluster_tris", "has_instances", "use_brute",
           "light_kinds", "lamp_types", "num_area_lamps",
           "background_shader", "volume_stack_depth")
# per grid: flat prims, clusters, triangles a cluster, closest-hit walk
TABLES = {4: (8450, 385, 30, "cluster_walk"), 5: (13202, 599, 32,
                                                   "tile_walk")}


def port_builder(lo, hi, max_leaf_size=4):
    """The shim: the port's C++ builder in the JAX package's place."""
    return native.build_bvh_native(lo, hi, max_leaf_size)


@pytest.fixture(scope="module")
def shimmed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_bvh_native", port_builder)
        yield


def _pair(grid):
    js = jex.instanced_scene(W, W, spp=SPP, grid=grid)
    js.device_update()
    ts = tex.instanced_scene(W, W, spp=SPP, grid=grid)
    ts.device_update()
    return (js.make_kernel_globals(device_put=False),
            ts.make_kernel_globals("cpu"))


@pytest.fixture(scope="module")
def pairs(shimmed):
    return {g: _pair(g) for g in TABLES}


@pytest.mark.parametrize("grid", sorted(TABLES))
@pytest.mark.parametrize("name", KG_ARRAYS + KG_DENSE)
def test_scene_arrays_equal(pairs, grid, name):
    jkg, tkg = pairs[grid]
    ref = np.asarray(jkg["dscene"][name])
    got = tkg["dscene"][name].numpy()
    assert ref.shape == got.shape
    # uint32 bit masks are int32 on the torch side
    assert got.dtype == (np.int32 if ref.dtype == np.uint32 else ref.dtype)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("grid", sorted(TABLES))
def test_statics_equal(pairs, grid):
    jkg, tkg = pairs[grid]
    assert jkg["kint"] == tkg["kint"]
    for k in STATICS:
        assert jkg[k] == tkg[k], k
    assert set(jkg["cam"]) == set(tkg["cam"])
    for k, v in jkg["cam"].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(tkg["cam"][k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(jkg["filter_table"]),
                                  tkg["filter_table"].numpy())
    assert [s.name for s in jkg["shaders"]] == [s.name for s in tkg["shaders"]]
    on = {k for k, v in jkg["features"].items() if v is True}
    assert on == {k for k, v in tkg["features"].items() if v}
    jt, tt = jkg["textures"], tkg["textures"]
    np.testing.assert_array_equal(np.asarray(jt.data), tt.data.numpy())
    assert jt.pixel_angle == tt.pixel_angle


@pytest.mark.parametrize("grid", sorted(TABLES))
def test_flattened_tables_and_dispatch(pairs, grid):
    """Flattened single-level tables of the stated size, and the walks the
    dispatch picks for them."""
    _jkg, tkg = pairs[grid]
    prims, clusters, ct, walk = TABLES[grid]
    ds = tkg["dscene"]
    assert ds["prim_table"].shape[0] == prims
    assert ds["cluster_bounds"].shape == (clusters, 6)
    assert tkg["cluster_tris"] == ct
    assert not tkg["has_instances"] and tkg["use_brute"] is False
    assert "sc_bounds" not in ds
    assert integ._closest_walk_name(tkg) == walk
    assert integ._use_occlusion_walk(tkg)


def test_cli_loads_the_configuration():
    scene, flags = cli.load_scene("example:textured_instanced")
    assert flags == {}
    assert (int(scene.camera.width), int(scene.camera.height)) == (256, 256)
    assert int(scene.integrator.aa_samples) == 64
    assert int(scene.integrator.max_bounce) == 4
    assert len(scene.objects) == 17


def test_kg_from_jax_renders_the_same(pairs):
    """The JAX package's kernel globals, converted, render the port's
    image bit for bit."""
    jkg, tkg = pairs[4]
    ckg = kg_from_jax(jkg, "cpu")
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    a = integ.render_samples_regen(ckg, px, py, pidx, 0, 2)[0]
    b = integ.render_samples_regen(tkg, px, py, pidx, 0, 2)[0]
    assert torch.equal(a, b)


def jax_render(width, spp, chunk, grid=4, clamp_off=False, rows=None,
               render=None):
    """The JAX package's instanced_scene(grid) image at width x width x
    spp, in chunks of `chunk` samples accumulated in float64, the film in
    strips of `rows` rows (a lane's samples depend on its pixel alone).
    Call under the shim."""
    js = jex.instanced_scene(width, width, spp=spp, grid=grid)
    if clamp_off:
        js.integrator.set("sample_clamp_indirect", 0.0)
    js.device_update()
    kg = js.make_kernel_globals()
    render = render or jinteg.render_samples_regen
    rows = rows or width
    fn = jax.jit(lambda a, b, c, s: render(kg, a, b, c, s, chunk))
    img = np.zeros((width, width, 3))
    for y0 in range(0, width, rows):
        yy, xx = np.mgrid[y0:y0 + rows, 0:width]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        acc = sum(np.asarray(fn(px, py, py * width + px, jnp.uint32(s))[0],
                             np.float64) for s in range(0, spp, chunk))
        img[y0:y0 + rows] = acc.reshape(rows, width, 3) / spp
    return img


def test_render_matches_jax(pairs, shimmed):
    _jkg, tkg = pairs[4]
    px, py, pidx = pixel_wavefront(W, W, 1, "cpu")
    before = (k2.launches, k3.launches)
    L, A = integ.render_samples_regen(tkg, px, py, pidx, 0, SPP)
    assert (k2.launches, k3.launches) == before  # CPU: the plain versions
    assert torch.equal(A, torch.full_like(A, float(SPP)))
    got = (L / SPP).numpy().reshape(W, W, 3)
    ref = jax_render(W, SPP, SPP)
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert abs(got.mean() / ref.mean() - 1.0) <= 1e-3
    assert (np.abs(got - ref).max(-1) <= 1e-3).mean() >= 0.98


def wavefronts():
    """F2's check: the float64 twin render over the whole frame and a row
    at a time, each against the other and against the twins."""
    whole = jax_render(64, 128, 16, clamp_off=True)
    by_row = jax_render(64, 128, 16, clamp_off=True, rows=1,
                        render=jinteg.render_samples)
    for twin in ("twin_f64_r04", "twin_f64"):
        ref = np.load(f"artifacts/{twin}.npz")["textured_instanced"]
        for label, img in (("whole frame", whole), ("row by row", by_row)):
            d = img - ref
            print(f"{label}: rmse vs {twin} {np.sqrt(np.mean(d * d)):.3e}, "
                  f"max |d| {np.abs(d).max():.3e}")
    print(f"whole frame vs row by row: max |d| "
          f"{np.abs(whole - by_row).max():.3e}")


if __name__ == "__main__":
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_bvh_native", port_builder)
        if sys.argv[1] == "wavefronts":
            wavefronts()
        else:
            width, spp, chunk, grid = (int(x) for x in sys.argv[2:6])
            img = jax_render(width, spp, chunk, grid, rows=64)
            print("mean", width, spp, chunk, grid,
                  repr(float(img.mean())))
