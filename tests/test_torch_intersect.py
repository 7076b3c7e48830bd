"""The plain cluster walks (raytracingproject_tpu_torch/ops/
cluster_intersect.py) against the JAX package: intersect_clusters vs the
XLA walk (ops/cluster_intersect.py), occlusion_clusters vs the Pallas
occlusion kernel in interpret mode (ops/pallas_cluster.py), on 2048
seeded random rays through the glossy Cornell box's cluster tables. The
glossy scene has no volume-boundary prims, so the occlusion tests plant a
seeded random 0/1 boundary table to exercise both of its minima."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.bvh.build import _wt_intersect_np
from raytracingproject_tpu.ops import cluster_intersect as jci
from raytracingproject_tpu.ops import pallas_cluster as pcl
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from raytracingproject_tpu_torch.ops import cluster_walk as k2
from raytracingproject_tpu_torch.ops import intersect as tis
from raytracingproject_tpu_torch.ops import occlusion_walk as k3

torch.set_num_threads(1)
N = 2048
CT = 15


@pytest.fixture(scope="module")
def setup():
    js = jex.cornell_box(64, 64, spp=2, spheres="glossy")
    js.device_update()
    ds = js.make_kernel_globals(device_put=False)["dscene"]
    tabs = {k: np.asarray(ds[k]) for k in ("cluster_bounds", "cluster_table",
                                           "cluster_boundary", "prim_table")}
    r = np.random.default_rng(1)
    o = r.uniform((-300,) * 3, (900,) * 3, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = {"o": o, "d": d, "tmin": np.full(N, 1e-4, np.float32),
            "tmax": np.full(N, 1e30, np.float32),
            "tmax_any": np.where(r.uniform(size=N) < 0.5,
                                 r.uniform(10, 800, N), 1e30
                                 ).astype(np.float32),
            "tmax_c": r.uniform(10, 1000, N).astype(np.float32)}
    tabs["planted_boundary"] = r.integers(
        0, 2, tabs["cluster_boundary"].shape).astype(np.float32)
    return tabs, rays


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_t_close(ref_t, got_t, prim, tabs, rays):
    """t within rtol 1e-5; a lane outside it must be a short-t lane where
    the JAX walk's FMA contraction rounds differently: there the port's t
    equals the repo's float32 numpy golden test (bvh/build.py
    _wt_intersect_np, no contraction) bit for bit."""
    bad = ~np.isclose(got_t, ref_t, rtol=1e-5, atol=0.0)
    assert bad.mean() <= 1e-3
    for i in np.nonzero(bad)[0]:
        tri = tabs["prim_table"][prim[i], :9].reshape(3, 3)
        t_np, _u, _v = _wt_intersect_np(tri, rays["o"][i], rays["d"][i])
        assert got_t[i] == t_np, (i, got_t[i], ref_t[i], t_np)


def test_watertight_matches_numpy_golden(setup):
    """Single-triangle spec test: the torch watertight test equals the
    float32 numpy golden on every hit lane."""
    tabs, rays = setup
    tv = tabs["prim_table"][:, :9].reshape(-1, 3, 3)
    r = np.random.default_rng(5)
    pid = r.integers(0, len(tv), 256)
    o, d = rays["o"][:256], rays["d"][:256]
    # aim each ray at a random point of its triangle
    bary = r.dirichlet((1, 1, 1), 256).astype(np.float32)
    target = np.einsum("nk,nkj->nj", bary, tv[pid]).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ws = tis.watertight_setup(_t(o), _t(d))
    tri = _t(tv[pid])
    valid, t, u, v = tis.watertight_test(
        ws, tuple(tri[:, 0, j] for j in range(3)),
        tuple(tri[:, 1, j] for j in range(3)),
        tuple(tri[:, 2, j] for j in range(3)), 0.0, 1e30)
    assert valid.float().mean() > 0.95
    for i in np.nonzero(valid.numpy())[0]:
        t_np, u_np, v_np = _wt_intersect_np(tv[pid[i]], o[i], d[i])
        assert (t[i].item(), u[i].item(), v[i].item()) == (t_np, u_np, v_np)


def test_intersect_clusters_closest(setup):
    tabs, rays = setup
    vis = np.full(N, 1, np.uint32)
    ref = jci.intersect_clusters(
        jnp.asarray(tabs["cluster_bounds"]), jnp.asarray(tabs["cluster_table"]),
        CT, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
        jnp.asarray(rays["tmin"]), jnp.asarray(rays["tmax"]),
        visibility=jnp.asarray(vis))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tci.intersect_clusters(
        _t(tabs["cluster_bounds"]), _t(tabs["cluster_table"]), CT,
        _t(rays["o"]), _t(rays["d"]), _t(rays["tmin"]), _t(rays["tmax"]),
        _t(vis.astype(np.int32)))
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(ref["prim"], got["prim"])
    np.testing.assert_array_equal(ref["object"], got["object"])
    _assert_t_close(ref["t"], got["t"], got["prim"], tabs, rays)
    np.testing.assert_allclose(got["u"], ref["u"], atol=1e-5)
    np.testing.assert_allclose(got["v"], ref["v"], atol=1e-5)
    assert (ref["prim"] >= 0).mean() > 0.2


@pytest.mark.parametrize("vis_bits", [1, 128])
def test_intersect_clusters_any_hit(setup, vis_bits):
    tabs, rays = setup
    vis = np.full(N, vis_bits, np.uint32)
    tmax = rays["tmax_any"]
    ref = jci.intersect_clusters(
        jnp.asarray(tabs["cluster_bounds"]), jnp.asarray(tabs["cluster_table"]),
        CT, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
        jnp.asarray(rays["tmin"]), jnp.asarray(tmax),
        visibility=jnp.asarray(vis), shadow_any_hit=True)
    got = tci.intersect_clusters(
        _t(tabs["cluster_bounds"]), _t(tabs["cluster_table"]), CT,
        _t(rays["o"]), _t(rays["d"]), _t(rays["tmin"]), _t(tmax),
        _t(vis.astype(np.int32)), shadow_any_hit=True)
    np.testing.assert_array_equal(np.asarray(ref["prim"]) >= 0,
                                  got["prim"].numpy() >= 0)


def _subset_table(tabs, keep):
    """cluster_table with the prim id of every slot outside `keep`
    ((C, ct) bool) set to -1, so a walk skips those prims."""
    ctab = tabs["cluster_table"].copy()
    pbase = 13 + 9 * CT
    ctab[:, pbase:pbase + CT] = np.where(keep, ctab[:, pbase:pbase + CT],
                                         np.float32(-1.0))
    return ctab


@pytest.mark.parametrize("form", ["surface", "dual"])
def test_occlusion_clusters_vs_pallas(setup, form):
    tabs, rays = setup
    tmax_c = rays["tmin"] if form == "surface" else rays["tmax_c"]
    cbd = tabs["planted_boundary"]
    jb, jo, jblk = pcl.occlusion_clusters_pallas(
        jnp.asarray(tabs["cluster_bounds"]), jnp.asarray(tabs["cluster_table"]),
        jnp.asarray(cbd), CT, jnp.asarray(rays["o"]),
        jnp.asarray(rays["d"]), jnp.asarray(rays["tmin"]),
        tmax_closest=jnp.asarray(tmax_c),
        tmax_any=jnp.asarray(rays["tmax_any"]), vis_closest=1, vis_any=128,
        interpret=True)
    tb, to, blk = tci.occlusion_clusters(
        _t(tabs["cluster_bounds"]), _t(tabs["cluster_table"]), _t(cbd), CT,
        _t(rays["o"]), _t(rays["d"]), _t(rays["tmin"]), _t(tmax_c),
        _t(rays["tmax_any"]), 1, 128)
    np.testing.assert_array_equal(np.asarray(jblk), blk.numpy())
    assert 0.05 < blk.float().mean() < 0.95
    if form == "surface":
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert (tb.numpy() >= 1e29).all() and (to.numpy() >= 1e29).all()
        return
    # each minimum is a closest-hit distance over its subset of prims:
    # equal to the plain walk over that subset, and within the walk's FMA
    # caveat of the Pallas kernel
    for got, ref, keep in ((tb, jb, cbd > 0), (to, jo, cbd <= 0)):
        closest = tci.intersect_clusters(
            _t(tabs["cluster_bounds"]), _t(_subset_table(tabs, keep)), CT,
            _t(rays["o"]), _t(rays["d"]), _t(rays["tmin"]), _t(tmax_c),
            torch.ones(N, dtype=torch.int32))
        np.testing.assert_array_equal(
            got.numpy(), np.where(closest["prim"].numpy() >= 0,
                                  closest["t"].numpy(), np.float32(1e30)))
        _assert_t_close(np.asarray(ref), got.numpy(),
                        closest["prim"].numpy(), tabs, rays)
        assert (got.numpy() < 1e29).mean() > 0.02
    assert ((tb.numpy() < 1e29) & (to.numpy() < 1e29)).any()


def test_wrappers_take_the_plain_version_on_cpu(setup):
    """On CPU tensors the K2/K3 wrappers return the plain walks' results
    and launch nothing."""
    tabs, rays = setup
    cb, ctab, cbd = (_t(tabs[k]) for k in ("cluster_bounds",
                                           "cluster_table",
                                           "cluster_boundary"))
    o, d, tmin, tmax = (_t(rays[k]) for k in ("o", "d", "tmin", "tmax"))
    vis = torch.ones(N, dtype=torch.int32)
    n2, n3 = k2.launches, k3.launches
    a = k2.intersect_clusters_walk(cb, ctab, CT, o, d, tmin, tmax, vis)
    b = tci.intersect_clusters(cb, ctab, CT, o, d, tmin, tmax, vis)
    assert all(torch.equal(a[k], b[k]) for k in a)
    x = k3.occlusion_clusters_walk(cb, ctab, cbd, CT, o, d, tmin, tmin,
                                   _t(rays["tmax_any"]), 1, 128)
    y = tci.occlusion_clusters(cb, ctab, cbd, CT, o, d, tmin, tmin,
                               _t(rays["tmax_any"]), 1, 128)
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert (k2.launches, k3.launches) == (n2, n3)


def test_wrappers_refuse_what_the_kernels_do_not_take(setup):
    tabs, rays = setup
    meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in tabs.items()}
    o = torch.empty((4, 3), device="meta")
    t1 = torch.empty(4, device="meta")
    vis = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k2.intersect_clusters_walk(meta["cluster_bounds"],
                                   meta["cluster_table"], CT, o, o, t1, t1,
                                   vis)
    with pytest.raises(ValueError):
        k3.occlusion_clusters_walk(meta["cluster_bounds"],
                                   meta["cluster_table"],
                                   meta["cluster_boundary"], CT, o, o, t1,
                                   t1, t1, 1, 128)
    cb = _t(tabs["cluster_bounds"])
    # motion rows never carry instances (no such table is packed)
    with pytest.raises(NotImplementedError):
        k2.intersect_clusters_walk(cb, cb, CT, cb, cb, cb, cb, cb,
                                   has_instances=True, has_motion=True)
    with pytest.raises(NotImplementedError):
        k3.occlusion_clusters_walk(cb, cb, cb, CT, cb, cb, cb, cb, cb, 1, 1,
                                   has_instances=True, has_motion=True)
