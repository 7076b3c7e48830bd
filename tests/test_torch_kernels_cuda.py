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
glossy tables; K4 and K5 also against their scan-order and queue-order
mirrors of the warp's visit order (ops/tile_walk.py, ops/cluster2_walk.py),
every output and every count equal on every lane. The instance rows of
single-level tables: K2, K4, K3 (both forms) and K7 through
instanced_scene(grid=6) (577 clusters x 38) and instanced_scene(grid=5,
nlat=15) (401 x 48), t, u, v to the bit where prim and object agree, and
K4 there against its mirrors too. The motion rows of two-level tables:
K5 and K6 through glossy_deform_big (936 clusters x 64), against the
plain motion walk, their mirrors at the lanes' times, and at time 0
against their static walks over glossy_big's tables. K3's
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


def _dense_args(kg, mode, o, d, tmin, seed):
    """K1's arguments in `mode` on the scene's dense arrays, mixed per-lane
    visibility (a planted boundary mask where the scene has none)."""
    ds = kg["dscene"]
    tv, po, ov = ds["tri_verts_world"], ds["prim_object_packed"], \
        ds["object_visibility"]
    n = o.shape[0]
    r = np.random.default_rng(seed)
    tmax_any = torch.tensor(np.where(r.uniform(size=n) < 0.5,
                                     r.uniform(10, 800, n), 1e30)
                            .astype(np.float32), device="cuda")
    vis = torch.tensor(np.array([1, 8, 16, 4, 128], np.int32)[
        r.integers(0, 5, n)], device="cuda")
    if mode == "closest":
        return (tv, po, o, d, tmin, torch.full((n,), 1e30, device="cuda"),
                vis, ov)
    if mode == "any":
        return tv, po, o, d, tmin, tmax_any, vis, ov
    bnd = ds["prim_is_boundary"]
    if not bool(bnd.any()):
        bnd = torch.tensor(r.uniform(size=len(po)) < 0.3, device="cuda")
    tmax_c = torch.tensor(r.uniform(10, 1000, n).astype(np.float32),
                          device="cuda")
    return (tv, po, bnd, o, d, tmin, tmax_c, tmax_any, vis,
            torch.full((n,), 128, dtype=torch.int32, device="cuda"), ov)


K1_WRAPPER = {"closest": (k1.intersect_brute_sweep, isect.intersect_brute),
              "any": (k1.shadow_blocked_sweep, isect.shadow_blocked_brute),
              "dual": (k1.occlusion_sweep, isect.intersect_brute_occlusion)}


def _outputs(x):
    return list(x.values()) if isinstance(x, dict) else (
        list(x) if isinstance(x, tuple) else [x])


@pytest.mark.parametrize("scene", ["cornell", "volume_sss"])
@pytest.mark.parametrize("mode", ["closest", "any", "dual"])
def test_dense_sweep_kernel_grazing(kg_cornell, kg_volume, scene, mode):
    """K1's render modes on the grazing set (ops/dense_sweep.py
    grazing_rays), where the cull's pads are tightest: every output equal
    to the plain version's to the bit."""
    kg = kg_cornell if scene == "cornell" else kg_volume
    o, d, tmin = k1.grazing_rays(kg["dscene"]["tri_verts_world"], N, 12)
    args = _dense_args(kg, mode, o, d, tmin, 13)
    kern, plain = K1_WRAPPER[mode]
    got, ref = kern(*args), plain(*args)
    torch.cuda.synchronize()
    hit = ref["prim"] >= 0 if mode == "closest" else _outputs(ref)[-1]
    assert bool(hit.any())
    for a, b in zip(_outputs(got), _outputs(ref)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scene", ["cornell", "volume_sss"])
@pytest.mark.parametrize("mode", ["closest", "any", "dual"])
def test_dense_sweep_kernel_edge_on(kg_cornell, kg_volume, scene, mode):
    """K1's render modes on rays nearly along the triangles' edges
    (ops/dense_sweep.py edge_rays), where the watertight test accepts
    farthest outside a triangle: every output equal to the plain
    version's to the bit."""
    kg = kg_cornell if scene == "cornell" else kg_volume
    o, d, tmin = k1.edge_rays(kg["dscene"]["tri_verts_world"], N, 14)
    args = _dense_args(kg, mode, o, d, tmin, 15)
    kern, plain = K1_WRAPPER[mode]
    got, ref = kern(*args), plain(*args)
    torch.cuda.synchronize()
    hit = ref["prim"] >= 0 if mode == "closest" else _outputs(ref)[-1]
    assert bool(hit.any())
    for a, b in zip(_outputs(got), _outputs(ref)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rays", ["random", "camera"])
def test_dual_walk_closest_to_the_bit(kg, rays):
    """K7's closest ray visits K2's clusters in K2's order: its t, u, v,
    prim and object equal the plain walk's to the bit on every lane, ties
    included; blocked equal."""
    ds = kg["dscene"]
    tabs = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"])
    if rays == "random":
        o, d, _tmax_any, _ = _rays(14)
        r = np.random.default_rng(15)
        vis_c = torch.tensor(np.array([1, 8, 16], np.int32)[
            r.integers(0, 3, N)], device="cuda")
        tmin = torch.full((N,), 1e-4, device="cuda")
    else:
        side = 256
        from raytracingproject_tpu_torch.ops import camera as cam_ops
        cam = dict(kg["cam"])
        yy, xx = np.mgrid[0:side, 0:side]
        rx = torch.tensor((xx.reshape(-1) + 0.5) * cam["width"] / side,
                          dtype=torch.float32, device="cuda")
        ry = torch.tensor((yy.reshape(-1) + 0.5) * cam["height"] / side,
                          dtype=torch.float32, device="cuda")
        z = torch.zeros_like(rx)
        ray = cam_ops.camera_sample_ray(cam, rx, ry, z, z, z)
        o, d = ray["o"].contiguous(), ray["d"].contiguous()
        vis_c = torch.ones(N, dtype=torch.int32, device="cuda")
        tmin = torch.zeros(N, device="cuda")
    # the any-hit rays leave the closest rays' first hits toward the lamp
    first = ci.intersect_clusters(*tabs, o, d, tmin,
                                  torch.full((N,), 1e30, device="cuda"),
                                  torch.ones(N, dtype=torch.int32,
                                             device="cuda"))
    p = o + torch.clamp(first["t"], max=2000.0)[:, None] * d
    to_l = torch.tensor([278.0, 548.0, 279.0], device="cuda") - p
    o_a = (p + 0.05 * to_l / to_l.norm(dim=-1, keepdim=True)).contiguous()
    to_l = torch.tensor([278.0, 548.0, 279.0], device="cuda") - o_a
    dist = to_l.norm(dim=-1)
    d_a = (to_l / dist[:, None]).contiguous()
    args = (*tabs, o, d, tmin, torch.full((N,), 1e30, device="cuda"), vis_c,
            o_a, d_a, torch.full((N,), 1e-4, device="cuda"),
            (dist * 0.999).contiguous(),
            torch.full((N,), 128, dtype=torch.int32, device="cuda"))
    got, blk = k7.intersect_clusters_dual_walk(*args)
    ref, rblk = ci.intersect_clusters_dual(*args)
    torch.cuda.synchronize()
    assert torch.equal(blk, rblk) and bool(blk.any())
    assert (ref["prim"] >= 0).float().mean().item() > 0.05
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("kernel", ["closest", "any", "dual", "K7"])
def test_counting_variants_keep_the_outputs(kg, kg_volume, kernel):
    """counts=True runs the counting variant: the same outputs as the
    plain launch, and counts of the shape and sense the wrappers state."""
    o, d, _tmax_any, _ = _rays(16)
    if kernel == "K7":
        ds = kg["dscene"]
        tmin = torch.full((N,), 1e-4, device="cuda")
        big = torch.full((N,), 1e30, device="cuda")
        vis = torch.ones(N, dtype=torch.int32, device="cuda")
        args = (ds["cluster_bounds"], ds["cluster_table"],
                kg["cluster_tris"], o, d, tmin, big, vis, o, d, tmin,
                torch.full((N,), 300.0, device="cuda"), vis)
        ref = k7.intersect_clusters_dual_walk(*args)
        *got, cnt = k7.intersect_clusters_dual_walk(*args, counts=True)
        width, c = 4, int(ds["cluster_bounds"].shape[0])
    else:
        tmin = torch.full((N,), 1e-4, device="cuda")
        args = _dense_args(kg_volume, kernel, o, d, tmin, 17)
        kern = K1_WRAPPER[kernel][0]
        ref = kern(*args)
        out = kern(*args, counts=True)
        got, cnt = (out[:3], out[3]) if kernel == "dual" else out
        width = 3
    torch.cuda.synchronize()
    for a, b in zip(_outputs(got if kernel != "K7" else tuple(got)),
                    _outputs(ref)):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
    assert cnt.shape == (N, width) and cnt.dtype == torch.int32
    assert bool((cnt >= 0).all()) and bool((cnt[:, 0] > 0).any())
    if kernel == "K7":
        # one pass at least per lane, at most C boxes per ray and pass
        assert bool((cnt[:, 2] >= 1).all())
        assert bool((cnt[:, 3] <= cnt[:, 2] * 2 * c).all())
        assert bool((cnt[:, 1] <= cnt[:, 0]).all())
    else:
        # the warp keeps at least what each of its lanes keeps
        assert bool((cnt[:, 2] >= cnt[:, 1]).all())


def _in_scan_order(module, kern, scan, queue, args, any_hit, instances):
    """The kernel's five outputs equal its scan-order mirror's on every
    lane, ties included; its counting variant's outputs equal the plain
    launch's and its counts the queue-order mirror's."""
    kw = {"shadow_any_hit": any_hit}
    if instances:
        kw["has_instances"] = True
    before = module.launches
    got = kern(*args, **kw)
    got_c, cnt = kern(*args, counts=True, **kw)
    ref, _ = scan(*args, **kw)
    _, qcnt = queue(*args, **kw)
    torch.cuda.synchronize()
    assert module.launches == before + 2
    assert (ref["prim"] >= 0).float().mean().item() > 0.05
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got_c[k], got[k]), k
    assert torch.equal(cnt, qcnt)


@pytest.mark.parametrize("scene", ["glossy", "volume_sss", "grid640"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_walk_kernel_in_scan_order(kg, kg_volume, scene, any_hit):
    """K4 visits the earlier design's clusters in its order (the
    lexicographic warp minimum of (entry, cluster)), from per-lane queues:
    held to ops/tile_walk.py tile_scan_order and tile_queue_order on the
    glossy and volume_sss tables and a 640-cluster grid table."""
    o, d, tmax_any, _ = _rays(18)
    if scene == "grid640":
        cb, ctab, _ = k4.grid_tables(640, 15, np.random.default_rng(19),
                                     "cuda")
        tabs = (cb, ctab, 15)
        o = (o + 300.0) * (270.0 / 1200.0)
    else:
        ds = (kg if scene == "glossy" else kg_volume)["dscene"]
        tabs = (ds["cluster_bounds"], ds["cluster_table"],
                (kg if scene == "glossy" else kg_volume)["cluster_tris"])
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    args = (*tabs, o.contiguous(), d, tmin, tmax,
            torch.ones(N, dtype=torch.int32, device="cuda"))
    _in_scan_order(k4, k4.intersect_clusters_tile, k4.tile_scan_order,
                   k4.tile_queue_order, args, any_hit, False)


@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster2_walk_kernel_in_scan_order(kg_instanced, any_hit):
    """K5 on the big_instanced tables, held to ops/cluster2_walk.py
    cluster2_scan_order and cluster2_queue_order (instance rows)."""
    ds = kg_instanced["dscene"]
    o, d, tmax_any, _ = _rays(20, lo=-20.0, hi=20.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    args = (ds["sc_bounds"], ds["cluster_bounds"], ds["cluster_table"],
            kg_instanced["cluster_tris"], kg_instanced["sc_gmax"], o, d,
            tmin, tmax, torch.ones(N, dtype=torch.int32, device="cuda"))
    _in_scan_order(k5, k5.intersect_clusters2_walk, k5.cluster2_scan_order,
                   k5.cluster2_queue_order, args, any_hit, True)


# ---- instance rows in single-level tables (K2, K3, K4, K7) ----------

SINGLE = {"grid6": {"grid": 6}, "grid5_nlat15": {"grid": 5, "nlat": 15}}


@pytest.fixture(scope="module")
def kg_single():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    out = {}
    for name, kw in SINGLE.items():
        s = examples.instanced_scene(64, 64, spp=2, **kw)
        s.device_update()
        out[name] = s.make_kernel_globals("cuda")
        assert out[name]["has_instances"] and "sc_bounds" not in \
            out[name]["dscene"]
    return out


def _assert_to_the_bit(got, ref):
    """Hit masks equal; prim and object equal off exact-t ties (<= 1e-4
    of lanes, the same t there); t, u, v equal to the bit where they
    agree."""
    assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    assert (ref["prim"] >= 0).float().mean().item() > 0.05
    same = (got["prim"] == ref["prim"]) & (got["object"] == ref["object"])
    assert (~same).float().mean().item() <= 1e-4
    torch.testing.assert_close(got["t"][~same], ref["t"][~same], rtol=1e-6,
                               atol=1e-4)
    for k in ("t", "u", "v"):
        assert torch.equal(got[k][same], ref[k][same]), k


@pytest.mark.parametrize("kernel,scene", [("K2", "grid5_nlat15"),
                                          ("K4", "grid6"),
                                          ("K4", "grid5_nlat15")])
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_kernels_with_instance_rows(kg_single, kernel, scene, any_hit):
    module, fn = {"K2": (k2, k2.intersect_clusters_walk),
                  "K4": (k4, k4.intersect_clusters_tile)}[kernel]
    kg = kg_single[scene]
    ds = kg["dscene"]
    o, d, tmax_any, _ = _rays(31, lo=-15.0, hi=15.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            o, d, tmin, tmax, torch.ones(N, dtype=torch.int32, device="cuda"))
    before = module.launches
    got = fn(*args, shadow_any_hit=any_hit, has_instances=True)
    ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit,
                                has_instances=True)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    if any_hit:
        assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
        return
    _assert_to_the_bit(got, ref)


@pytest.mark.parametrize("form", ["surface", "dual"])
def test_occlusion_walk_kernel_with_instance_rows(kg_single, form):
    """K3 on grid=6's table with a seeded random boundary table: every
    output to the bit (minima and OR do not depend on the visit order)."""
    kg = kg_single["grid6"]
    ds = kg["dscene"]
    o, d, tmax_any, _ = _rays(32, lo=-15.0, hi=15.0)
    tmax_c = torch.where(tmax_any < 1e29, tmax_any, 30.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    cbd = torch.tensor(np.random.default_rng(33).integers(
        0, 2, ds["cluster_boundary"].shape).astype(np.float32),
        device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], cbd,
            kg["cluster_tris"], o, d, tmin,
            tmin if form == "surface" else tmax_c, tmax_any, 1, 128)
    before = k3.launches
    got = k3.occlusion_clusters_walk(*args, has_instances=True)
    ref = ci.occlusion_clusters(*args, has_instances=True)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert 0.05 < ref[2].float().mean().item() < 0.95
    if form == "dual":
        assert (ref[0] < 1e29).float().mean().item() > 0.01
        assert (ref[1] < 1e29).float().mean().item() > 0.01


@pytest.mark.parametrize("disabled", [None, "any"])
def test_dual_walk_kernel_with_instance_rows(kg_single, disabled):
    """K7 on grid=5 / nlat=15's table: closest rays from inside the
    scene, any-hit rays toward the sun; blocked equal, the closest hit to
    the bit."""
    kg = kg_single["grid5_nlat15"]
    ds = kg["dscene"]
    o, d, _tmax_any, _ = _rays(34, lo=-15.0, hi=15.0)
    sun = torch.tensor([0.3, -0.4, 0.85], device="cuda")
    sun = sun / sun.norm()
    o_a = (o + 0.05 * sun).contiguous()
    d_a = sun.expand(N, 3).contiguous()
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax_c = torch.full((N,), 1e30, device="cuda")
    tmax_a = torch.full((N,), -1.0 if disabled else 1e30, device="cuda")
    vis = torch.ones(N, dtype=torch.int32, device="cuda")
    vis_a = torch.full((N,), 128, dtype=torch.int32, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            o, d, tmin, tmax_c, vis, o_a, d_a, tmin, tmax_a, vis_a)
    before = k7.launches
    got, blk = k7.intersect_clusters_dual_walk(*args, has_instances=True)
    ref, rblk = ci.intersect_clusters_dual(*args, has_instances=True)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    assert torch.equal(blk, rblk)
    if disabled:
        assert not blk.any()
    else:
        assert 0.02 < blk.float().mean().item() < 0.98
    _assert_to_the_bit(got, ref)


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_walk_kernel_in_scan_order_with_instance_rows(kg_single,
                                                          any_hit):
    """K4 on grid=6's table, held to tile_scan_order and
    tile_queue_order with instance rows."""
    kg = kg_single["grid6"]
    ds = kg["dscene"]
    o, d, tmax_any, _ = _rays(35, lo=-15.0, hi=15.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            o, d, tmin, tmax, torch.ones(N, dtype=torch.int32, device="cuda"))
    _in_scan_order(k4, k4.intersect_clusters_tile, k4.tile_scan_order,
                   k4.tile_queue_order, args, any_hit, True)


# ---- deforming motion: motion rows (K2, K3, K4) and K1's deform modes --


@pytest.fixture(scope="module")
def kg_deform():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    out = {}
    for name, fn in (("glossy", examples.glossy_deform_scene),
                     ("cornell", examples.cornell_deform_scene)):
        s = fn(64, 64, spp=2)
        s.device_update()
        out[name] = s.make_kernel_globals("cuda")
        assert out[name]["has_deform_motion"]
    assert out["glossy"]["cluster_motion"]
    return out


def _times(seed):
    return torch.tensor(np.random.default_rng(seed).uniform(0.0, 1.0, N)
                        .astype(np.float32), device="cuda")


@pytest.mark.parametrize("kernel", ["K2", "K4"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_kernels_with_motion_rows(kg_deform, kernel, any_hit):
    """K2 and K4 on glossy_deform's motion table, random rays at random
    times: to the bit against the plain motion walk (K4 off exact-t
    ties; tests/test_torch_deform.py holds it to its scan mirror)."""
    module, fn = {"K2": (k2, k2.intersect_clusters_walk),
                  "K4": (k4, k4.intersect_clusters_tile)}[kernel]
    kg = kg_deform["glossy"]
    ds = kg["dscene"]
    o, d, tmax_any, _ = _rays(41, lo=0.0, hi=556.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            o, d, tmin, tmax, torch.ones(N, dtype=torch.int32, device="cuda"))
    kw = {"shadow_any_hit": any_hit, "has_motion": True,
          "time": _times(42)}
    before = module.launches
    got = fn(*args, **kw)
    ref = ci.intersect_clusters(*args, **kw)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    if any_hit:
        assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
        return
    _assert_to_the_bit(got, ref)
    if kernel == "K2":
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_walk_kernel_in_scan_order_with_motion_rows(kg_deform, any_hit):
    kg = kg_deform["glossy"]
    ds = kg["dscene"]
    o, d, tmax_any, _ = _rays(43, lo=0.0, hi=556.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            o, d, tmin, tmax, torch.ones(N, dtype=torch.int32, device="cuda"))
    tm = _times(44)
    kw = {"shadow_any_hit": any_hit, "has_motion": True, "time": tm}
    got = k4.intersect_clusters_tile(*args, **kw)
    got_c, cnt = k4.intersect_clusters_tile(*args, counts=True, **kw)
    ref, _ = k4.tile_scan_order(*args, **kw)
    _, qcnt = k4.tile_queue_order(*args, **kw)
    torch.cuda.synchronize()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got_c[k], got[k]), k
    assert torch.equal(cnt, qcnt)


@pytest.mark.parametrize("form", ["surface", "dual"])
def test_occlusion_walk_kernel_with_motion_rows(kg_deform, form):
    kg = kg_deform["glossy"]
    ds = kg["dscene"]
    o, d, tmax_any, _ = _rays(45, lo=0.0, hi=556.0)
    tmax_c = torch.where(tmax_any < 1e29, tmax_any, 300.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    cbd = torch.tensor(np.random.default_rng(46).integers(
        0, 2, ds["cluster_boundary"].shape).astype(np.float32),
        device="cuda")
    args = (ds["cluster_bounds"], ds["cluster_table"], cbd,
            kg["cluster_tris"], o, d, tmin,
            tmin if form == "surface" else tmax_c, tmax_any, 1, 128)
    kw = {"has_motion": True, "time": _times(47)}
    before = k3.launches
    got = k3.occlusion_clusters_walk(*args, **kw)
    ref = ci.occlusion_clusters(*args, **kw)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert 0.05 < ref[2].float().mean().item() < 0.95


@pytest.mark.parametrize("path", ["two_step", "three_step"])
@pytest.mark.parametrize("mode", ["closest", "any", "dual"])
def test_dense_sweep_kernel_deform(kg_deform, path, mode):
    """K1's deform modes on cornell_deform's path (and its last step
    alone, a two-step path), random rays at random times, mixed
    visibility: every output to the bit; the counting variant keeps them
    and its kept blocks are block_keep's mirror's."""
    kg = kg_deform["cornell"]
    ds = kg["dscene"]
    steps = ds["tri_verts_world_steps"]
    if path == "two_step":
        steps = steps[-1:].contiguous()
    o, d, _tmax_any, _ = _rays(48, lo=0.0, hi=556.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    args = _dense_args(kg, mode, o, d, tmin, 49)
    kw = {"tri_verts_t1": steps, "time": _times(50)}
    wrap, plain = K1_WRAPPER[mode]
    before = k1.launches[mode]
    got = wrap(*args, **kw)
    got_c = wrap(*args, counts=True, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert k1.launches[mode] == before + 2
    for a, b in zip(_outputs(got), _outputs(ref)):
        assert torch.equal(a, b)
    cnt = got_c[-1]
    for a, b in zip(_outputs(got_c[0] if mode != "dual" else got_c[:3]),
                    _outputs(got)):
        assert torch.equal(a, b)
    names = {"closest": ("tri_verts", "prim_object", "o", "d", "tmin",
                         "tmax", "visibility", "object_visibility"),
             "any": ("tri_verts", "prim_object", "o", "d", "tmin", "tmax",
                     "visibility", "object_visibility"),
             "dual": ("tri_verts", "prim_object", "boundary_mask", "o",
                      "d", "tmin", "tmax_closest", "tmax_any",
                      "visibility_closest", "visibility_any",
                      "object_visibility")}[mode]
    a = dict(zip(names, args), **kw)
    kept, tested = k1.kept_blocks(mode, a)
    assert torch.equal(cnt[:, 1], kept.sum(1).to(torch.int32))
    if tested is not None:
        assert torch.equal(cnt[:, 0], tested)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_dense_sweep_kernel_deform_far_moving_quad(kg_deform, mode):
    """A quad of extent 2 sliding 10 along x over the shutter (one block,
    moving five times its extent, past even the shutter-open wide box),
    rays aimed where it is at their times: the kernel keeps the block
    through its boxes over every step and equals the plain sweep to the
    bit, hitting nearly every lane."""
    quad = torch.tensor([[[-1, -1, 0], [1, -1, 0], [1, 1, 0]],
                         [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]],
                        dtype=torch.float32, device="cuda")
    steps = (quad + torch.tensor([10.0, 0.0, 0.0], device="cuda"))[None]
    r = np.random.default_rng(51)
    tm = r.uniform(0.0, 1.0, N).astype(np.float32)
    p = np.stack([10.0 * tm + r.uniform(-0.8, 0.8, N),
                  r.uniform(-0.8, 0.8, N), np.zeros(N)], 1)
    d = np.concatenate([r.normal(0.0, 0.05, (N, 2)), -np.ones((N, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.tensor((p - 5.0 * d).astype(np.float32), device="cuda")
    d = torch.tensor(d.astype(np.float32), device="cuda")
    po = torch.zeros(2, dtype=torch.int32, device="cuda")
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = torch.full((N,), 1e30, device="cuda")
    kw = {"tri_verts_t1": steps.contiguous(),
          "time": torch.tensor(tm, device="cuda")}
    wrap, plain = K1_WRAPPER[mode]
    got = wrap(quad, po, o, d, tmin, tmax, **kw)
    ref = plain(quad, po, o, d, tmin, tmax, **kw)
    torch.cuda.synchronize()
    for a, b in zip(_outputs(got), _outputs(ref)):
        assert torch.equal(a, b)
    hit = ref["prim"] >= 0 if mode == "closest" else ref
    assert hit.float().mean().item() > 0.95


@pytest.fixture(scope="module")
def kg_deform_big():
    """glossy_deform_big's two-level motion tables (936 clusters x 64 in
    25 superclusters) and glossy_big's static ones (the same clusters at
    shutter open)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    out = {}
    for name, fn in (("motion", examples.glossy_deform_big_scene),
                     ("static", examples.glossy_big_scene)):
        s = fn(64, 64, spp=2)
        s.device_update()
        out[name] = s.make_kernel_globals("cuda")
    assert out["motion"]["cluster_motion"]
    assert "sc_bounds" in out["motion"]["dscene"]
    return out


def _two_level_args(kg, o, d, tmin, tmax):
    ds = kg["dscene"]
    n = o.shape[0]
    return (ds["sc_bounds"], ds["cluster_bounds"], ds["cluster_table"],
            int(kg["cluster_tris"]), int(kg["sc_gmax"]), o, d, tmin, tmax,
            torch.ones(n, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("kernel", ["K5", "K6"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_two_level_kernels_with_motion_rows(kg_deform_big, kernel, any_hit):
    """K5 and K6 on glossy_deform_big's motion rows, random rays from
    inside the box at random times: hit masks equal to the plain motion
    walk's and t, u, v to the bit off exact-t ties; every output equal to
    the scan-order mirror's at the lanes' times; the counting variant's
    outputs the plain launch's and its counts the queue-order mirror's;
    at time 0 the kernel's static walk over glossy_big's tables."""
    module, fn = {"K5": (k5, k5.intersect_clusters2_walk),
                  "K6": (k6, k6.intersect_clusters2_onehot)}[kernel]
    scan = {"K5": k5.cluster2_scan_order, "K6": k6.onehot2_scan_order}
    queue = {"K5": k5.cluster2_queue_order, "K6": k6.onehot2_queue_order}
    o, d, tmax_any, _ = _rays(61, lo=0.0, hi=556.0)
    tmin = torch.full((N,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((N,), 1e30, device="cuda")
    args = _two_level_args(kg_deform_big["motion"], o, d, tmin, tmax)
    kw = {"shadow_any_hit": any_hit, "has_motion": True,
          "time": _times(62)}
    before = module.launches
    got = fn(*args, **kw)
    got_c, cnt = fn(*args, counts=True, **kw)
    ref = ci.intersect_clusters(*args[1:4], *args[5:], **kw)
    mirror = scan[kernel](*args, **kw)[0]
    qcnt = queue[kernel](*args, **kw)[1]
    torch.cuda.synchronize()
    assert module.launches == before + 2
    for k in mirror:
        assert torch.equal(got[k], mirror[k]), k
        assert torch.equal(got_c[k], got[k]), k
    assert torch.equal(cnt, qcnt)
    if any_hit:
        assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    else:
        _assert_to_the_bit(got, ref)
    zero = {"shadow_any_hit": any_hit, "has_motion": True,
            "time": torch.zeros(N, device="cuda")}
    at0 = fn(*args, **zero)
    static = fn(*_two_level_args(kg_deform_big["static"], o, d, tmin, tmax),
                shadow_any_hit=any_hit)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(at0["prim"] >= 0, static["prim"] >= 0)
    else:
        _assert_to_the_bit(at0, static)
