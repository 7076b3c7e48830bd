"""The hand-written CUDA kernels against their plain torch versions, on
the card: K2 (ops/cluster_walk.py, closest and any hit) and K3
(ops/occlusion_walk.py, surface and dual windows), 65,536 rays through
the glossy Cornell box's cluster tables, and K4 (ops/tile_walk.py,
closest and any hit) through the glossy and the volume_sss tables, and
K5 (ops/cluster2_walk.py, closest and any hit, instance rows) through the
big_instanced two-level tables, K6 (ops/onehot2_walk.py) through the same
tables, and K1 (ops/dense_sweep.py: closest, any hit, the dual form and
the Moeller-Trumbore mode) through the dense arrays of cornell_diffuse
(36 prims) and volume_sss (1,008 prims), and K7 (ops/dual_walk.py: a
closest-hit ray with mixed per-lane visibility paired with an any-hit ray
toward the lamp, and each ray switched off by an empty window) through the
glossy tables. K3's
dual form runs on a seeded random volume-boundary table (the glossy
scene's own is all zeros), so both of its minima are exercised. Kernel
and plain version share one operation order and the kernels build with
-fmad=false, so hit masks agree and prims and distances agree except on
exact-t ties (<= 1e-4 of lanes; volume_sss's random rays meet more of
them, see test_tile_walk_kernel).

Marked `cuda`: skipped where no card is present (decided in the fixture,
never at import). On the GPU machine:
    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
(--noconftest: tests/conftest.py imports jax, which that machine lacks)
"""

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.app import examples
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk as k2
from raytracingproject_tpu_torch.ops import dense_sweep as k1
from raytracingproject_tpu_torch.ops import dual_walk as k7
from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
from raytracingproject_tpu_torch.ops import onehot2_walk as k6
from raytracingproject_tpu_torch.ops import tile_walk as k4

pytestmark = pytest.mark.cuda
N = 65536


@pytest.fixture(scope="module")
def kg():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    s = examples.cornell_box(64, 64, spheres="glossy")
    s.device_update()
    return s.make_kernel_globals("cuda")


@pytest.fixture(scope="module")
def kg_volume():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    s = examples.volume_sss_scene(64, 64, spp=2)
    s.device_update()
    return s.make_kernel_globals("cuda")


@pytest.fixture(scope="module")
def kg_instanced():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    s = examples.instanced_scene(64, 64, spp=2, grid=8)
    s.device_update()
    return s.make_kernel_globals("cuda")


def _rays(seed, lo=-300.0, hi=900.0):
    r = np.random.default_rng(seed)
    o = r.uniform((lo,) * 3, (hi,) * 3, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax_any = np.where(r.uniform(size=N) < 0.5, r.uniform(10, 800, N),
                        1e30).astype(np.float32)
    tmax_c = r.uniform(10, 1000, N).astype(np.float32)
    return [torch.tensor(a, device="cuda") for a in (o, d, tmax_any, tmax_c)]


def _check_walk(module, fn, kg, any_hit, seed, tie_frac=1e-4):
    ds = kg["dscene"]
    o, d, tmax_any, _ = _rays(seed)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    vis = torch.ones(N, dtype=torch.int32, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            o, d, tmin, tmax, vis)
    before = module.launches
    got = fn(*args, shadow_any_hit=any_hit)
    ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert (ref["prim"] >= 0).float().mean().item() > 0.05
    if any_hit:
        assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
        return
    assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    same = (got["prim"] == ref["prim"]) & (got["object"] == ref["object"])
    assert (~same).float().mean().item() <= tie_frac
    # a lane whose winner differs is an exact tie: the same t, to ~1 ulp
    # of the scene's coordinates (the two t round in the ray's shear frame)
    torch.testing.assert_close(got["t"][~same], ref["t"][~same], rtol=1e-6,
                               atol=1e-4)
    torch.testing.assert_close(got["t"][same], ref["t"][same], rtol=1e-5,
                               atol=0)
    for k in ("u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_walk_kernel(kg, any_hit):
    _check_walk(k2, k2.intersect_clusters_walk, kg, any_hit, 1)


@pytest.mark.parametrize("disabled", [None, "any", "closest"])
def test_dual_walk_kernel(kg, disabled):
    """K7 against its plain version: blocked equal everywhere, the closest
    hit equal except where two triangles tie in t (the union's visit order
    picks another of them)."""
    ds = kg["dscene"]
    o, d, _tmax_any, _ = _rays(8)
    r = np.random.default_rng(9)
    o_a = o + 0.05
    to_l = torch.tensor([278.0, 548.0, 279.0], device="cuda") - o_a
    dist = to_l.norm(dim=-1)
    d_a = (to_l / dist[:, None]).contiguous()
    tmin = torch.full((N,), 1e-4, device="cuda")
    empty = torch.full((N,), -1.0, device="cuda")
    tmax_c = empty if disabled == "closest" \
        else torch.full((N,), 1e30, device="cuda")
    tmax_a = empty if disabled == "any" else dist * 0.999
    vis_c = torch.tensor(np.array([1, 8, 16], np.int32)[r.integers(0, 3, N)],
                         device="cuda")
    vis_a = torch.full((N,), 128, dtype=torch.int32, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            o, d, tmin, tmax_c, vis_c, o_a, d_a, tmin, tmax_a, vis_a)
    before = k7.launches
    got, blk = k7.intersect_clusters_dual_walk(*args)
    ref, rblk = ci.intersect_clusters_dual(*args)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    assert torch.equal(blk, rblk)
    assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    if disabled == "any":
        assert not blk.any()
    else:
        assert 0.05 < blk.float().mean().item() < 0.95
    if disabled == "closest":
        assert (got["prim"] == -1).all() and torch.equal(got["t"], empty)
        return
    assert (ref["prim"] >= 0).float().mean().item() > 0.05
    same = (got["prim"] == ref["prim"]) & (got["object"] == ref["object"])
    assert (~same).float().mean().item() <= 1e-4
    torch.testing.assert_close(got["t"][~same], ref["t"][~same], rtol=1e-6,
                               atol=1e-4)
    torch.testing.assert_close(got["t"][same], ref["t"][same], rtol=1e-5,
                               atol=0)
    for k in ("u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("scene", ["glossy", "volume_sss"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_walk_kernel(kg, kg_volume, scene, any_hit):
    """In volume_sss the two boxes' bottom faces lie in the floor's plane.
    A random ray from below the floor that meets them hits two coplanar
    triangles at one t, and the tile's visit order and the lane's pick
    different ones: ~1e-3 of these rays (an exact tie each, checked)."""
    _check_walk(k4, k4.intersect_clusters_tile,
                kg if scene == "glossy" else kg_volume, any_hit, 4,
                tie_frac=1e-4 if scene == "glossy" else 2e-3)


@pytest.mark.parametrize("form", ["surface", "dual"])
def test_occlusion_walk_kernel(kg, form):
    ds = kg["dscene"]
    o, d, tmax_any, tmax_c = _rays(2)
    tmin = torch.full((N,), 1e-4, device="cuda")
    cbd = ds["cluster_boundary"]
    if form == "dual":
        cbd = torch.tensor(np.random.default_rng(3).integers(
            0, 2, cbd.shape).astype(np.float32), device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], cbd,
            kg["cluster_tris"], o, d, tmin,
            tmin if form == "surface" else tmax_c, tmax_any, 1, 128)
    before = k3.launches
    tb, to, blk = k3.occlusion_clusters_walk(*args)
    rb, ro, rblk = ci.occlusion_clusters(*args)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    assert torch.equal(blk, rblk)
    torch.testing.assert_close(tb, rb, rtol=1e-5, atol=0)
    torch.testing.assert_close(to, ro, rtol=1e-5, atol=0)
    if form == "dual":
        assert (rb < 1e29).float().mean().item() > 0.01
        assert (ro < 1e29).float().mean().item() > 0.01


@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster2_walk_kernel(kg_instanced, any_hit):
    """K5 on the big_instanced tables (1,025 clusters in 65 superclusters,
    instance rows), rays from inside the scene's bounds."""
    _check_walk2(k5, k5.intersect_clusters2_walk, kg_instanced, any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_onehot2_walk_kernel(kg_instanced, any_hit):
    """K6 on the same tables and rays, against the same plain walk."""
    _check_walk2(k6, k6.intersect_clusters2_onehot, kg_instanced, any_hit)


def _check_walk2(module, fn, kg_instanced, any_hit):
    ds = kg_instanced["dscene"]
    o, d, tmax_any, _ = _rays(5, lo=-20.0, hi=20.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    vis = torch.ones(N, dtype=torch.int32, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"],
            kg_instanced["cluster_tris"], o, d, tmin, tmax, vis)
    before = module.launches
    got = fn(
        ds["sc_bounds"], *args[:3], kg_instanced["sc_gmax"], *args[3:],
        shadow_any_hit=any_hit, has_instances=True)
    ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit,
                                has_instances=True)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert (ref["prim"] >= 0).float().mean().item() > 0.05
    assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    if any_hit:
        return
    same = (got["prim"] == ref["prim"]) & (got["object"] == ref["object"])
    assert (~same).float().mean().item() <= 1e-4
    torch.testing.assert_close(got["t"][~same], ref["t"][~same], rtol=1e-6,
                               atol=1e-4)
    torch.testing.assert_close(got["t"][same], ref["t"][same], rtol=0,
                               atol=0)
    for k in ("u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def kg_cornell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    s = examples.cornell_box(64, 64)
    s.device_update()
    return s.make_kernel_globals("cuda")


@pytest.mark.parametrize("scene", ["cornell", "volume_sss"])
@pytest.mark.parametrize("mode", ["closest", "any", "dual", "mt"])
def test_dense_sweep_kernel(kg_cornell, kg_volume, scene, mode):
    """K1's four modes, mixed per-lane visibility, a tenth of the windows
    empty. Kernel and plain version share the block-of-8 winner rule, so
    prims are equal, not only hit masks; t, u, v are equal to the bit."""
    kg = kg_cornell if scene == "cornell" else kg_volume
    ds = kg["dscene"]
    tv, po, ov = ds["tri_verts_world"], ds["prim_object_packed"], \
        ds["object_visibility"]
    o, d, tmax_any, tmax_c = _rays(6)
    r = np.random.default_rng(7)
    tmin = torch.full((N,), 1e-4, device="cuda")
    empty = torch.tensor(r.uniform(size=N) < 0.1, device="cuda")
    tmax_any = torch.where(empty, tmin, tmax_any)
    vis = torch.tensor(np.array([1, 8, 16, 4, 128], np.int32)[
        r.integers(0, 5, N)], device="cuda")
    before = k1.launches[mode]
    if mode == "closest":
        got = k1.intersect_brute_sweep(tv, po, o, d, tmin, tmax_any, vis, ov)
        ref = isect.intersect_brute(tv, po, o, d, tmin, tmax_any, vis, ov)
        assert (ref["prim"] >= 0).float().mean().item() > 0.05
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    elif mode == "any":
        got = k1.shadow_blocked_sweep(tv, po, o, d, tmin, tmax_any, vis, ov)
        ref = isect.shadow_blocked_brute(tv, po, o, d, tmin, tmax_any, vis,
                                         ov)
        assert ref.float().mean().item() > 0.05
        assert torch.equal(got, ref)
    elif mode == "dual":
        bnd = ds["prim_is_boundary"]
        if not bool(bnd.any()):   # cornell has no volume: plant a mask
            bnd = torch.tensor(r.uniform(size=len(po)) < 0.3, device="cuda")
        vis_a = torch.full((N,), 128, dtype=torch.int32, device="cuda")
        args = (tv, po, bnd, o, d, tmin, tmax_c, tmax_any, vis, vis_a, ov)
        got = k1.occlusion_sweep(*args)
        ref = isect.intersect_brute_occlusion(*args)
        assert (ref[0] < 1e29).any() and (ref[1] < 1e29).any()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    else:
        _nb, v0, e1, e2, _po, _pv = isect.pack_tri_blocks(tv, po, None)
        packets = [x.contiguous() for x in (v0, e1, e2)]
        got = k1.intersect_mt_sweep(*packets, o, d, tmin, tmax_any)
        ref = isect.intersect_brute_mt(*packets, o, d, tmin, tmax_any)
        assert (ref["prim"] >= 0).float().mean().item() > 0.05
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    torch.cuda.synchronize()
    assert k1.launches[mode] == before + 1
