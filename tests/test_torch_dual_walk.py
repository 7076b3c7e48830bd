"""K7's plain version (raytracingproject_tpu_torch/ops/cluster_intersect.py
intersect_clusters_dual, which the wrapper ops/dual_walk.py takes on CPU
tensors) against the JAX package's union walk
(ops/pallas_onehot.py intersect_clusters_onehot_dual, run in interpret
mode with tile=1024 as its own tests run it): the same numpy-seeded rays
through both, on the glossy Cornell box's cluster tables. 1,536 closest
rays with mixed per-lane visibility, paired with any-hit rays from nearby
origins toward the lamp. prim, object and blocked are equal; t agrees to
rtol 1e-5, except on a few short-t lanes (<= 0.2%) where the JAX walk's
jit contracts multiply-adds and the port does not: there the port's t
equals the repo's float32 numpy golden test (bvh/build.py
_wt_intersect_np, no contraction) bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.bvh.build import _wt_intersect_np
from raytracingproject_tpu.ops import pallas_onehot as po
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from raytracingproject_tpu_torch.ops import dual_walk as k7

torch.set_num_threads(1)
N = 1536
CAMERA, DIFFUSE, GLOSSY, SHADOW = 1, 8, 16, 128


@pytest.fixture(scope="module")
def tables():
    js = jex.cornell_box(64, 64, spp=2, spheres="glossy")
    js.device_update()
    jkg = js.make_kernel_globals()
    jds = jkg["dscene"]
    jtabs = (jds["oh_cbounds"], jds["oh_table_hi"], jds["oh_table_mid"],
             jds["oh_table_lo"],
             int(jkg.get("oh_cluster_tris", 0) or jkg["cluster_tris"]))
    ts = tex.cornell_box(64, 64, spp=2, spheres="glossy")
    ts.device_update()
    tkg = ts.make_kernel_globals("cpu")
    tds = tkg["dscene"]
    ttabs = (tds["cluster_bounds"], tds["cluster_table"],
             int(tkg["cluster_tris"]))
    return jtabs, ttabs, np.asarray(jds["prim_table"])


def _assert_t_close(got, ref, r, prim_table):
    bad = ~np.isclose(got["t"], ref["t"], rtol=1e-5, atol=0.0)
    assert bad.mean() <= 2e-3
    for i in np.nonzero(bad)[0]:
        tri = prim_table[got["prim"][i], :9].reshape(3, 3)
        t_np, _u, _v = _wt_intersect_np(tri, r["o_c"][i], r["d_c"][i])
        assert got["t"][i] == t_np, (i, got["t"][i], ref["t"][i], t_np)


def _rays(seed, n=N):
    r = np.random.default_rng(seed)
    o_c = r.uniform((-300,) * 3, (900,) * 3, (n, 3)).astype(np.float32)
    d_c = r.normal(size=(n, 3)).astype(np.float32)
    d_c /= np.linalg.norm(d_c, axis=1, keepdims=True)
    # any-hit rays: from slightly different origins toward the lamp
    o_a = (o_c + 0.05).astype(np.float32)
    to_l = np.array([278.0, 548.0, 279.0], np.float32)[None] - o_a
    dist = np.linalg.norm(to_l, axis=1).astype(np.float32)
    d_a = (to_l / dist[:, None]).astype(np.float32)
    vis_c = np.array([CAMERA, DIFFUSE, GLOSSY], np.int32)[r.integers(0, 3, n)]
    return {"o_c": o_c, "d_c": d_c, "o_a": o_a, "d_a": d_a,
            "tmin": np.full(n, 1e-4, np.float32),
            "tmax_c": np.full(n, 1e30, np.float32),
            "tmax_a": (dist * 0.999).astype(np.float32),
            "vis_c": vis_c, "vis_a": np.full(n, SHADOW, np.int32),
            "empty": np.full(n, -1.0, np.float32)}


def _jax_dual(jtabs, r, tmax_c="tmax_c", tmax_a="tmax_a", vis_a="vis_a"):
    *tabs, ct = jtabs
    j = {k: jnp.asarray(v) for k, v in r.items()}
    hit, blk = po.intersect_clusters_onehot_dual(
        *tabs, ct, j["o_c"], j["d_c"], j["tmin"], j[tmax_c],
        j["vis_c"].astype(jnp.uint32), j["o_a"], j["d_a"], j["tmin"],
        j[tmax_a], j[vis_a].astype(jnp.uint32), tile=1024, interpret=True)
    return {k: np.asarray(v) for k, v in hit.items()}, np.asarray(blk)


def _port_dual(ttabs, r, tmax_c="tmax_c", tmax_a="tmax_a", vis_a="vis_a",
               fn=k7.intersect_clusters_dual_walk):
    t = {k: torch.from_numpy(v) for k, v in r.items()}
    before = k7.launches
    hit, blk = fn(*ttabs, t["o_c"], t["d_c"], t["tmin"], t[tmax_c],
                  t["vis_c"], t["o_a"], t["d_a"], t["tmin"], t[tmax_a],
                  t[vis_a])
    assert k7.launches == before   # no kernel launch on CPU tensors
    return {k: v.numpy() for k, v in hit.items()}, blk.numpy()


def test_dual_matches_jax_union_walk(tables):
    jtabs, ttabs, prim_table = tables
    r = _rays(31)
    ref, ref_blk = _jax_dual(jtabs, r)
    got, got_blk = _port_dual(ttabs, r)
    np.testing.assert_array_equal(got["prim"], ref["prim"])
    np.testing.assert_array_equal(got["object"], ref["object"])
    np.testing.assert_array_equal(got_blk, ref_blk)
    _assert_t_close(got, ref, r, prim_table)
    hit = ref["prim"] >= 0
    np.testing.assert_allclose(got["u"][hit], ref["u"][hit], atol=1e-4)
    np.testing.assert_allclose(got["v"][hit], ref["v"][hit], atol=1e-4)
    assert got["prim"].dtype == np.int32 and got_blk.dtype == np.bool_
    assert 0.05 < got_blk.mean() < 0.95 and hit.mean() > 0.2


def test_wrapper_is_the_plain_version_on_cpu(tables):
    _jtabs, ttabs, _pt = tables
    r = _rays(33, 512)
    a, a_blk = _port_dual(ttabs, r)
    b, b_blk = _port_dual(ttabs, r, fn=tci.intersect_clusters_dual)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a_blk, b_blk)


@pytest.mark.parametrize("disabled", ["any", "closest"])
def test_empty_window_disables_a_ray(tables, disabled):
    """tmax < tmin switches that ray of the lane off: the any ray is never
    blocked, the closest ray never hits; the other ray is not touched."""
    jtabs, ttabs, prim_table = tables
    r = _rays(32, 512)
    r["o_a"], r["d_a"] = r["o_c"], r["d_c"]
    r["tmax_a"] = r["tmax_c"]
    kw = {"tmax_a": "empty"} if disabled == "any" else {"tmax_c": "empty"}
    ref, ref_blk = _jax_dual(jtabs, r, **kw)
    got, got_blk = _port_dual(ttabs, r, **kw)
    np.testing.assert_array_equal(got["prim"], ref["prim"])
    np.testing.assert_array_equal(got_blk, ref_blk)
    _assert_t_close(got, ref, r, prim_table)
    if disabled == "any":
        assert not got_blk.any() and (got["prim"] >= 0).any()
    else:
        assert (got["prim"] == -1).all() and got_blk.any()


def test_miss_and_disabled_lane_t_convention(tables):
    """A miss returns t = min(tmax_c, RAY_TMAX) and prim = object = -1, so
    a disabled closest ray returns its own negative tmax_c."""
    _jtabs, ttabs, _pt = tables
    r = _rays(34, 256)
    r["o_c"] = (r["o_c"] + 5000.0).astype(np.float32)   # outside the scene,
    r["d_c"] = np.abs(r["d_c"])                         # heading away
    r["tmax_c"] = np.where(np.arange(256) % 3 == 0, 1e30,
                           np.where(np.arange(256) % 3 == 1, 3e38, -1.0)
                           ).astype(np.float32)
    got, _blk = _port_dual(ttabs, r)
    assert (got["prim"] == -1).all() and (got["object"] == -1).all()
    np.testing.assert_array_equal(
        got["t"], np.minimum(r["tmax_c"], np.float32(1e30)))


@pytest.mark.parametrize("case", ["instances", "motion", "clusters"])
def test_wrapper_refuses_what_the_kernel_does_not_take(tables, case):
    _jtabs, (cb, ctab, ct), _pt = tables
    r = {k: torch.from_numpy(v) for k, v in _rays(35, 8).items()}
    args = [cb, ctab, ct, r["o_c"], r["d_c"], r["tmin"], r["tmax_c"],
            r["vis_c"], r["o_a"], r["d_a"], r["tmin"], r["tmax_a"], r["vis_a"]]
    kw = {}
    if case == "motion":
        kw["has_motion"] = True
    else:
        # past the 512 clusters of the packed keys; instance rows, which
        # the kernel takes, do not lift that cap
        args[0] = cb[:1].repeat(513, 1)
        args[1] = ctab[:1].repeat(513, 1)
        if case == "instances":
            kw["has_instances"] = True
    with pytest.raises(NotImplementedError):
        k7.intersect_clusters_dual_walk(*args, **kw)
