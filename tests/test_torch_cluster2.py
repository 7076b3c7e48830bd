"""K5's contract on the port's plain walk with instance rows, against the
JAX package, on the big_instanced tables (instanced_scene(grid=8): 1,025
clusters x 38 triangles, 65 superclusters of at most 64 clusters):

- the port's group_superclusters and supercluster_bounds equal the JAX
  package's on the scene's cuts;
- the port's plain walk (ops/cluster_intersect.py intersect_clusters with
  has_instances, K5's plain version) against the JAX package's XLA walk
  intersect_clusters(has_instances=True), on 2,048 seeded rays from
  inside the scene's bounds and 1,024 camera rays, closest and any hit;
- the same walk against the JAX package's K5, intersect_clusters2_pallas
  in interpret mode with the scene's sc_bounds and gmax, on 1,024 of
  those rays.

Hit masks are equal, and prim and object off exact-t ties (none occur on
these rays). t is held to rtol 1e-5 and u, v to atol 1e-5. Where XLA:CPU
contracts a multiply-add (in the instance transform or the shear) the
JAX walks round a hit differently, up to 2e-4 relative on a few percent
of the lanes; there the port's t must equal, bit for bit, a float32 numpy
golden that transforms the ray by the row's w2o and runs the watertight
test without contraction (bvh/build.py _wt_intersect_np)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.bvh import build as jbuild
from raytracingproject_tpu.bvh import clusters as jcl
from raytracingproject_tpu.ops import cluster_intersect as jci
from raytracingproject_tpu.ops import pallas_cluster as pcl
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.bvh import build as tbuild
from raytracingproject_tpu_torch.bvh import clusters as tcl
from raytracingproject_tpu_torch.bvh.build import _wt_intersect_np
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_intersect as tci

torch.set_num_threads(1)
N_RANDOM = 2048
SIDE = 32          # 32 x 32 camera rays
N_PALLAS = 1024
# share of lanes where XLA:CPU's contraction moves t by more than rtol 1e-5
CONTRACTED_FRAC = 0.05


@pytest.fixture(scope="module")
def scene():
    ts = tex.instanced_scene(SIDE, SIDE, spp=2, grid=8)
    ts.device_update()
    kg = ts.make_kernel_globals("cpu")
    assert kg["has_instances"] and kg["sc_gmax"] == 64
    return kg


@functools.lru_cache(maxsize=None)
def _rays():
    """2,048 random rays from inside the scene's bounds (origins uniform
    in the union of the cluster boxes, isotropic directions), then the
    pixel-center camera rays of a 32 x 32 film."""
    ts = tex.instanced_scene(SIDE, SIDE, spp=2, grid=8)
    ts.device_update()
    kg = ts.make_kernel_globals("cpu")
    cb = kg["dscene"]["cluster_bounds"].numpy()
    r = np.random.default_rng(11)
    o = r.uniform(cb[:, :3].min(0), cb[:, 3:].max(0),
                  (N_RANDOM, 3)).astype(np.float32)
    d = r.normal(size=(N_RANDOM, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:SIDE, 0:SIDE]
    rx = torch.tensor(xx.reshape(-1) + 0.5, dtype=torch.float32)
    ry = torch.tensor(yy.reshape(-1) + 0.5, dtype=torch.float32)
    z = torch.zeros_like(rx)
    ray = cam_ops.camera_sample_ray(kg["cam"], rx, ry, z, z, z)
    o = np.concatenate([o, ray["o"].numpy()])
    d = np.concatenate([d, ray["d"].numpy()])
    n = len(o)
    tmin = np.concatenate([np.full(N_RANDOM, 1e-4, np.float32),
                           np.zeros(SIDE * SIDE, np.float32)])
    # any hit: half the segments end inside the scene (shadow-like)
    tmax_any = np.where(r.uniform(size=n) < 0.5, r.uniform(1.0, 40.0, n),
                        1e30).astype(np.float32)
    return o, d, tmin, tmax_any


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden(ctab, ct, prim, obj, o, d):
    """float32 numpy (t, u, v) of the hit (prim, object): the row holding
    it, the
    ray transformed by the row's w2o (m[0]*ox + m[1]*oy + m[2]*oz + m[3],
    left to right), the triangle rebuilt as v0, v0 + e1, v0 + e2."""
    pb = tci.META_COLS + 9 * ct
    rows, slots = np.nonzero((ctab[:, pb:pb + ct] == prim)
                             & (ctab[:, pb + ct:pb + 2 * ct] == obj))
    assert len(rows) == 1
    row, k = ctab[rows[0]], slots[0]
    m = row[:12]
    f = np.float32
    oo = np.array([f(f(f(m[4 * r] * o[0]) + f(m[4 * r + 1] * o[1]))
                     + f(m[4 * r + 2] * o[2])) + m[4 * r + 3]
                   for r in range(3)], np.float32)
    dd = np.array([f(f(m[4 * r] * d[0]) + f(m[4 * r + 1] * d[1]))
                   + f(m[4 * r + 2] * d[2]) for r in range(3)], np.float32)
    tri = row[tci.META_COLS + 9 * k:tci.META_COLS + 9 * k + 9].reshape(3, 3)
    tri = np.stack([tri[0], tri[0] + tri[1], tri[0] + tri[2]])
    return _wt_intersect_np(tri, oo, dd)


def _compare(kg, ref, got, o, d, any_hit):
    """Hit masks equal; off ties prim/object equal; t rtol 1e-5 and u, v
    atol 1e-5, else t, u, v equal the numpy golden bit for bit."""
    np.testing.assert_array_equal(ref["prim"] >= 0, got["prim"] >= 0)
    hit = got["prim"] >= 0
    assert 0.2 < hit.mean() < 0.9
    if any_hit:
        return
    np.testing.assert_array_equal(ref["prim"], got["prim"])
    np.testing.assert_array_equal(ref["object"], got["object"])
    np.testing.assert_array_equal(got["t"][~hit], ref["t"][~hit])
    close = np.isclose(got["t"], ref["t"], rtol=1e-5, atol=0.0) \
        & np.isclose(got["u"], ref["u"], rtol=0.0, atol=1e-5) \
        & np.isclose(got["v"], ref["v"], rtol=0.0, atol=1e-5)
    assert (~close).mean() <= CONTRACTED_FRAC
    ctab = kg["dscene"]["cluster_table"].numpy()
    ct = int(kg["cluster_tris"])
    for i in np.nonzero(~close)[0]:
        gold = _golden(ctab, ct, got["prim"][i], got["object"][i], o[i],
                       d[i])
        assert (got["t"][i], got["u"][i], got["v"][i]) == gold, i


def _port(kg, o, d, tmin, tmax, any_hit):
    ds = kg["dscene"]
    n = len(o)
    out = tci.intersect_clusters(
        ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"], _t(o),
        _t(d), _t(tmin), _t(tmax),
        torch.full((n,), ob.PATH_RAY_CAMERA, dtype=torch.int32),
        shadow_any_hit=any_hit, has_instances=True)
    return {k: v.numpy() for k, v in out.items()}


def test_supercluster_grouping_matches_jax(scene):
    """group_superclusters on the sphere BLAS's fine and coarse cuts, and
    supercluster_bounds on the scene's cluster bounds and groups."""
    sphere = tex.instanced_scene(8, 8, grid=1).objects[1].geometry
    tv = sphere.verts_array[sphere.triangles_array]
    for build, cl in ((tbuild, tcl), (jbuild, jcl)):
        b = build.build_bvh(tv.min(1), tv.max(1))
        fine, coarse = cl.cut_clusters(b.children, 16), \
            cl.cut_clusters(b.children, 128)
        if cl is tcl:
            got = (fine, coarse, cl.group_superclusters(fine, coarse, 4))
        else:
            ref = (fine, coarse, cl.group_superclusters(fine, coarse, 4))
    assert got == ref and len(got[2]) > len(coarse)
    ds = scene["dscene"]
    scb = ds["sc_bounds"].numpy()
    groups = [(int(r[6]), int(r[7])) for r in scb]
    assert len(groups) == 65 and {g for _s, g in groups} == {1, 16}
    cb = ds["cluster_bounds"].numpy()
    np.testing.assert_array_equal(tcl.supercluster_bounds(cb, groups),
                                  jcl.supercluster_bounds(cb, groups))
    np.testing.assert_array_equal(tcl.supercluster_bounds(cb, groups), scb)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_vs_jax_walk(scene, any_hit):
    o, d, tmin, tmax_any = _rays()
    n = len(o)
    tmax = tmax_any if any_hit else np.full(n, 1e30, np.float32)
    ds = scene["dscene"]
    ref = jci.intersect_clusters(
        jnp.asarray(ds["cluster_bounds"].numpy()),
        jnp.asarray(ds["cluster_table"].numpy()), scene["cluster_tris"],
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
        visibility=jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32),
        shadow_any_hit=any_hit, has_instances=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = _port(scene, o, d, tmin, tmax, any_hit)
    _compare(scene, ref, got, o, d, any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_vs_pallas_k5(scene, any_hit):
    """The JAX package's K5 (interpret mode) with the scene's real
    sc_bounds and gmax, on 512 random and 512 camera rays."""
    o, d, tmin, tmax_any = _rays()
    sel = np.r_[0:N_PALLAS // 2, N_RANDOM:N_RANDOM + N_PALLAS // 2]
    o, d, tmin, tmax_any = o[sel], d[sel], tmin[sel], tmax_any[sel]
    tmax = tmax_any if any_hit else np.full(N_PALLAS, 1e30, np.float32)
    ds = scene["dscene"]
    ref = pcl.intersect_clusters2_pallas(
        jnp.asarray(ds["sc_bounds"].numpy()),
        jnp.asarray(ds["cluster_bounds"].numpy()),
        jnp.asarray(ds["cluster_table"].numpy()), scene["cluster_tris"],
        scene["sc_gmax"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax),
        jnp.full((N_PALLAS,), ob.PATH_RAY_CAMERA, jnp.uint32),
        shadow_any_hit=any_hit, has_instances=True, interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = _port(scene, o, d, tmin, tmax, any_hit)
    _compare(scene, ref, got, o, d, any_hit)


def test_k5_wrapper_takes_the_plain_version_on_cpu(scene):
    ds = scene["dscene"]
    o, d, tmin, _ = _rays()
    args = (ds["cluster_bounds"], ds["cluster_table"], scene["cluster_tris"],
            _t(o[:256]), _t(d[:256]), _t(tmin[:256]),
            torch.full((256,), 1e30), torch.ones(256, dtype=torch.int32))
    before = k5.launches
    a = k5.intersect_clusters2_walk(ds["sc_bounds"], *args[:3],
                                    scene["sc_gmax"], *args[3:],
                                    has_instances=True)
    b = tci.intersect_clusters(*args, has_instances=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert k5.launches == before


def test_k5_wrapper_refuses_what_the_kernel_does_not_take(scene):
    ds = scene["dscene"]
    meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in ds.items() if v.ndim == 2}
    o = torch.empty((4, 3), device="meta")
    t1 = torch.empty(4, device="meta")
    vis = torch.empty(4, dtype=torch.int32, device="meta")
    ct, gmax = scene["cluster_tris"], scene["sc_gmax"]
    with pytest.raises(ValueError):   # not CUDA tensors
        k5.intersect_clusters2_walk(meta["sc_bounds"], meta["cluster_bounds"],
                                    meta["cluster_table"], ct, gmax, o, o, t1,
                                    t1, vis)
    # motion rows reach the argument checks; with instance rows they raise
    # (the JAX package packs no table of moving instances)
    with pytest.raises(ValueError):
        k5.intersect_clusters2_walk(meta["sc_bounds"], meta["cluster_bounds"],
                                    meta["cluster_table"], ct, gmax, o, o, t1,
                                    t1, vis, has_motion=True)
    with pytest.raises(NotImplementedError):
        k5.intersect_clusters2_walk(meta["sc_bounds"], meta["cluster_bounds"],
                                    meta["cluster_table"], ct, gmax, o, o, t1,
                                    t1, vis, has_instances=True,
                                    has_motion=True)
    # SC and gmax at the JAX package's caps overflow one warp's shared
    # memory: (512 + 512) x 32 x 4 B = 128 KB fits, 2 x 1,024 would not
    assert k5.smem_per_warp(512, 512, 469) <= k5.SMEM_BYTES
    assert k5.smem_per_warp(1024, 1024, 469) > k5.SMEM_BYTES
