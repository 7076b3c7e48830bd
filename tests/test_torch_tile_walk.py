"""K4's contract and K3's dual form on the port's plain walks, against the
JAX package's Pallas kernels in interpret mode (ops/pallas_cluster.py),
on seeded random rays through the volume_sss and the glossy cluster
tables:

- intersect_clusters (the plain version of K4, ops/tile_walk.py) against
  intersect_clusters_pallas, closest and any hit. The Pallas kernel walks
  a tile of 1,024 rays one cluster at a time, the plain walk each lane in
  its own order, so the winner may differ where two prims are hit at the
  same t: volume_sss's two boxes have bottom faces in the floor's plane,
  which rays from below the floor hit together. Hit masks are equal;
  prim and object are equal outside such tie lanes, where t agrees to
  rtol 1e-6 + atol 1e-4 (about an ulp of the scene's coordinates: the
  two t round in the ray's shear frame); elsewhere t is held to rtol 1e-5 and u, v to atol 1e-5, as
  tests/test_pallas_cluster.py holds the Pallas kernel to the XLA walk.
- occlusion_clusters (the plain version of K3) against
  occlusion_clusters_pallas with volume_sss's own volume-boundary table,
  full windows and per-lane windows with disabled lanes (1e-5), as the
  volume NEE builds them: blocked masks equal; each minimum equals the
  plain closest-hit walk over its subset of prims, and the Pallas
  kernel's within rtol 1e-5.

Where XLA:CPU contracts a multiply-add the JAX kernels round a short or
grazing hit differently (up to 2e-4 relative on a few lanes in 1,000);
there the port's t must equal the float32 numpy golden test
(bvh/build.py _wt_intersect_np, no contraction) bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import pallas_cluster as pcl
from raytracingproject_tpu_torch.bvh.build import _wt_intersect_np
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from raytracingproject_tpu_torch.ops import tile_walk as k4

torch.set_num_threads(1)
N = 2048
# share of random-ray lanes that may be coplanar ties (volume_sss: ~1e-3)
TIE_FRAC = 4e-3


def _tables(scene):
    if scene == "glossy":
        js = jex.cornell_box(64, 64, spp=2, spheres="glossy")
    else:
        js = jex.volume_sss_scene(64, 64, spp=2)
    js.device_update()
    kg = js.make_kernel_globals(device_put=False)
    ds = kg["dscene"]
    return {k: np.asarray(ds[k]) for k in ("cluster_bounds", "cluster_table",
                                           "cluster_boundary", "prim_table")}, \
        int(kg["cluster_tris"])


@pytest.fixture(scope="module")
def tables():
    return {s: _tables(s) for s in ("volume_sss", "glossy")}


def _rays(seed, n=N, lo=-300.0, hi=900.0):
    r = np.random.default_rng(seed)
    o = r.uniform((lo,) * 3, (hi,) * 3, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return r, o, d


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_t_close(ref_t, got_t, prim, prim_table, o, d):
    """t within rtol 1e-5 of the JAX kernel's, or else (XLA's FMA
    contraction) equal to the numpy golden on the hit prim."""
    bad = ~np.isclose(got_t, ref_t, rtol=1e-5, atol=0.0)
    assert bad.mean() <= 4e-3
    for i in np.nonzero(bad)[0]:
        tri = prim_table[prim[i], :9].reshape(3, 3)
        t_np, _u, _v = _wt_intersect_np(tri, o[i], d[i])
        assert got_t[i] == t_np, (i, got_t[i], ref_t[i], t_np)


def _subset_table(tabs, ct, keep):
    """cluster_table with the prim id of every slot outside `keep`
    ((C, ct) bool) set to -1, so a walk skips those prims."""
    ctab = tabs["cluster_table"].copy()
    pbase = tci.META_COLS + 9 * ct
    ctab[:, pbase:pbase + ct] = np.where(keep, ctab[:, pbase:pbase + ct],
                                         np.float32(-1.0))
    return ctab


@pytest.mark.parametrize("scene", ["volume_sss", "glossy"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_vs_pallas_tile_walk(tables, scene, any_hit):
    tabs, ct = tables[scene]
    r, o, d = _rays(1)
    tmin = np.full(N, 1e-4, np.float32)
    tmax = np.where(r.uniform(size=N) < 0.5, r.uniform(10, 800, N),
                    1e30).astype(np.float32) if any_hit \
        else np.full(N, 1e30, np.float32)
    vis = np.full(N, ob.PATH_RAY_CAMERA, np.uint32)
    ref = pcl.intersect_clusters_pallas(
        jnp.asarray(tabs["cluster_bounds"]), jnp.asarray(tabs["cluster_table"]),
        ct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), jnp.asarray(vis), shadow_any_hit=any_hit,
        interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = k4.intersect_clusters_tile(
        _t(tabs["cluster_bounds"]), _t(tabs["cluster_table"]), ct, _t(o),
        _t(d), _t(tmin), _t(tmax), _t(vis.astype(np.int32)),
        shadow_any_hit=any_hit)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(ref["prim"] >= 0, got["prim"] >= 0)
    assert 0.05 < (got["prim"] >= 0).mean() < 0.95
    if any_hit:
        return
    same = (ref["prim"] == got["prim"]) & (ref["object"] == got["object"])
    assert (~same).mean() <= TIE_FRAC
    np.testing.assert_allclose(got["t"][~same], ref["t"][~same], rtol=1e-6,
                               atol=1e-4)
    _assert_t_close(ref["t"][same], got["t"][same], got["prim"][same],
                    tabs["prim_table"], o[same], d[same])
    np.testing.assert_allclose(got["u"][same], ref["u"][same], atol=1e-5)
    np.testing.assert_allclose(got["v"][same], ref["v"][same], atol=1e-5)


@pytest.mark.parametrize("windows", ["full", "per_lane"])
def test_dual_occlusion_vs_pallas(tables, windows):
    """K3's dual form on volume_sss's real boundary table (the smoke
    box's 12 prims), rays from inside the box as in the JAX package's
    TestOcclusionDual, with the closest and any-hit windows of the volume
    NEE."""
    tabs, ct = tables["volume_sss"]
    assert 0 < tabs["cluster_boundary"].sum() <= 12
    r, o, d = _rays(2, lo=100.0, hi=456.0)
    if windows == "full":
        tmaxc = np.full(N, 1e30, np.float32)
        tmaxa = np.full(N, 1e30, np.float32)
    else:
        tmaxc = np.where(r.uniform(size=N) < 0.3, 1e-5,
                         r.uniform(5, 600, N)).astype(np.float32)
        tmaxa = np.where(r.uniform(size=N) < 0.3, 1e-5,
                         r.uniform(5, 600, N)).astype(np.float32)
    tmin = np.full(N, 1e-5, np.float32)
    jb, jo, jblk = pcl.occlusion_clusters_pallas(
        jnp.asarray(tabs["cluster_bounds"]), jnp.asarray(tabs["cluster_table"]),
        jnp.asarray(tabs["cluster_boundary"]), ct, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(tmin), tmax_closest=jnp.asarray(tmaxc),
        tmax_any=jnp.asarray(tmaxa), vis_closest=ob.PATH_RAY_CAMERA,
        vis_any=ob.PATH_RAY_SHADOW, interpret=True)
    tb, to, blk = tci.occlusion_clusters(
        _t(tabs["cluster_bounds"]), _t(tabs["cluster_table"]),
        _t(tabs["cluster_boundary"]), ct, _t(o), _t(d), _t(tmin), _t(tmaxc),
        _t(tmaxa), ob.PATH_RAY_CAMERA, ob.PATH_RAY_SHADOW)
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
    cbd = tabs["cluster_boundary"]
    for got, ref, keep in ((tb, jb, cbd > 0), (to, jo, cbd <= 0)):
        closest = tci.intersect_clusters(
            _t(tabs["cluster_bounds"]), _t(_subset_table(tabs, ct, keep)), ct,
            _t(o), _t(d), _t(tmin), _t(tmaxc),
            torch.full((N,), ob.PATH_RAY_CAMERA, dtype=torch.int32))
        hit = closest["prim"].numpy() >= 0
        np.testing.assert_array_equal(
            got.numpy(), np.where(hit, closest["t"].numpy(), np.float32(1e30)))
        _assert_t_close(np.asarray(ref)[hit], got.numpy()[hit],
                        closest["prim"].numpy()[hit], tabs["prim_table"],
                        o[hit], d[hit])
    # rays from inside the smoke box find its boundary; the shadow
    # visibility of the volume-only boundary is off, so it never blocks
    assert (tb.numpy() < 1e29).mean() > 0.3
    assert blk.numpy().any() and (to.numpy() < 1e29).any()


def test_k4_wrapper_takes_the_plain_version_on_cpu(tables):
    tabs, ct = tables["volume_sss"]
    _r, o, d = _rays(3, n=256)
    args = (_t(tabs["cluster_bounds"]), _t(tabs["cluster_table"]), ct, _t(o),
            _t(d), torch.full((256,), 1e-4), torch.full((256,), 1e30),
            torch.ones(256, dtype=torch.int32))
    before = k4.launches
    a = k4.intersect_clusters_tile(*args)
    b = tci.intersect_clusters(*args)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert k4.launches == before


def test_k4_wrapper_refuses_what_the_kernel_does_not_take(tables):
    tabs, ct = tables["volume_sss"]
    meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in tabs.items()}
    o = torch.empty((4, 3), device="meta")
    t1 = torch.empty(4, device="meta")
    vis = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k4.intersect_clusters_tile(meta["cluster_bounds"],
                                   meta["cluster_table"], ct, o, o, t1, t1,
                                   vis)
    cb = _t(tabs["cluster_bounds"])
    with pytest.raises(NotImplementedError):
        k4.intersect_clusters_tile(cb, cb, ct, cb, cb, cb, cb, cb,
                                   has_motion=True)
