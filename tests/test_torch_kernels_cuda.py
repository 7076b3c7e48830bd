"""The hand-written CUDA kernels against their plain torch versions, on
the card: K2 (ops/cluster_walk.py, closest and any hit) and K3
(ops/occlusion_walk.py, surface and dual windows), 65,536 rays through
the glossy Cornell box's cluster tables, and K4 (ops/tile_walk.py,
closest and any hit) through the glossy and the volume_sss tables, and
K5 (ops/cluster2_walk.py, closest and any hit, instance rows) through the
big_instanced two-level tables. K3's
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
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
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
    ds = kg_instanced["dscene"]
    o, d, tmax_any, _ = _rays(5, lo=-20.0, hi=20.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    vis = torch.ones(N, dtype=torch.int32, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"],
            kg_instanced["cluster_tris"], o, d, tmin, tmax, vis)
    before = k5.launches
    got = k5.intersect_clusters2_walk(
        ds["sc_bounds"], *args[:3], kg_instanced["sc_gmax"], *args[3:],
        shadow_any_hit=any_hit, has_instances=True)
    ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit,
                                has_instances=True)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
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
