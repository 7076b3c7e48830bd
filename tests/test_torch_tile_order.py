"""The warp's visit order of the tile-shared walks K4 (ops/tile_walk.py)
and K5 (ops/cluster2_walk.py), in their plain torch mirrors, on the CPU:

- the scan-order mirror (tile_scan_order, cluster2_scan_order: the
  earlier design, one entry-table scan per pick) against the plain walk
  ops/cluster_intersect.py intersect_clusters: hit masks equal; t, u, v,
  prim and object equal to the bit except where two triangles are hit at
  the same t (the warp's visit order differs from the lane's, and the t of
  coplanar triangles differ by an ulp); any hit: the blocked masks equal;
- the queue-order mirror (tile_queue_order, cluster2_queue_order: the
  kernels' design, per-lane queues of Q pairs, a retired bitmask, a box
  pass when a queue runs dry) against the scan-order mirror, for Q = 1, 2
  and 8: every output and every step count equal on every lane;
- rays whose lanes enter several clusters at one entry (origins inside
  overlapping boxes), where the warp's pick is decided by the cluster id.

Tables: volume_sss's (93 clusters x 15 triangles), a 640-cluster grid (the
single-level cap, ops/tile_walk.py grid_tables) and big_instanced's
two-level tables with instance rows (1,025 clusters in 65 superclusters),
all from the port's own host compile; seeded random rays. The CUDA
kernels are held to these mirrors on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.app import examples
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import tile_walk as k4

torch.set_num_threads(1)
# lanes whose winner may differ from the plain walk's (exact-t ties):
# volume_sss's boxes stand on the floor, and rays from below hit two
# coplanar triangles at one t
TIE_FRAC = 4e-3
TABLES = ("volume_sss", "grid640", "big_instanced")


def _rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(o), torch.tensor(d)


def _windows(rng, n, any_hit):
    tmin = torch.full((n,), 1e-4)
    if not any_hit:
        return tmin, torch.full((n,), 1e30)
    return tmin, torch.tensor(np.where(rng.uniform(size=n) < 0.5,
                                       rng.uniform(10, 800, n), 1e30)
                              .astype(np.float32))


def _table(name):
    if name == "grid640":
        cb, ctab, _ = k4.grid_tables(640, 15, np.random.default_rng(3))
        return {"cluster_bounds": cb, "cluster_table": ctab}, 15, None, \
            (-67.5, 337.5)
    if name == "volume_sss":
        s = examples.volume_sss_scene(16, 16, spp=2)
    else:
        s = examples.instanced_scene(16, 16, spp=2, grid=8)
    s.device_update()
    kg = s.make_kernel_globals("cpu")
    ds = kg["dscene"]
    cb = ds["cluster_bounds"].numpy()
    box = (cb[:, :3].min(0), cb[:, 3:].max(0))
    if name == "volume_sss":
        box = (-300.0, 900.0)
    return ds, int(kg["cluster_tris"]), kg.get("sc_gmax"), box


@pytest.fixture(scope="module")
def cases():
    """{(table, any_hit): (walk args, two-level extras or None, scan
    mirror's (hit, counts))}, the scan mirror run once per case."""
    out = {}
    for t, name in enumerate(TABLES):
        ds, ct, gmax, (lo, hi) = _table(name)
        for any_hit in (False, True):
            rng = np.random.default_rng(20 + 2 * t + any_hit)
            n = 1024 if name == "grid640" else 2048
            o, d = _rays(rng, n, lo, hi)
            tmin, tmax = _windows(rng, n, any_hit)
            args = (ds["cluster_bounds"], ds["cluster_table"], ct, o, d,
                    tmin, tmax, torch.ones(n, dtype=torch.int32))
            two = (ds["sc_bounds"], gmax) if name == "big_instanced" \
                else None
            out[(name, any_hit)] = (args, two, _scan(args, two, any_hit))
    return out


def _scan(args, two, any_hit):
    if two is None:
        return k4.tile_scan_order(*args, shadow_any_hit=any_hit)
    return k5.cluster2_scan_order(two[0], *args[:3], two[1], *args[3:],
                                  shadow_any_hit=any_hit, has_instances=True)


def _queue(args, two, any_hit, q):
    if two is None:
        return k4.tile_queue_order(*args, shadow_any_hit=any_hit, queue=q)
    return k5.cluster2_queue_order(two[0], *args[:3], two[1], *args[3:],
                                   shadow_any_hit=any_hit,
                                   has_instances=True, queue=q)


def _held_to_plain(args, two, any_hit, got):
    ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit,
                                has_instances=two is not None)
    assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    assert bool((ref["prim"] >= 0).any())
    if any_hit:
        return
    same = (got["prim"] == ref["prim"]) & (got["object"] == ref["object"])
    assert (~same).float().mean().item() <= TIE_FRAC
    for k in ("t", "u", "v"):
        assert torch.equal(got[k][same], ref[k][same]), k
    # a lane whose winner differs is an exact tie: the two t agree to an
    # ulp of the scene's coordinates (each walk keeps the first it meets
    # and culls a box whose entry is not below it)
    torch.testing.assert_close(got["t"][~same], ref["t"][~same], rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("table", TABLES)
def test_scan_order_against_the_plain_walk(cases, table, any_hit):
    args, two, (hit, cnt) = cases[(table, any_hit)]
    _held_to_plain(args, two, any_hit, hit)
    # every lane of a warp counts its warp's steps; a lane tests at most
    # the rows its warp fetched
    steps = cnt[:, 2 if two is not None else 0]
    assert bool((steps.view(-1, 32) == steps.view(-1, 32)[:, :1]).all())
    assert bool((cnt[:, 3 if two is not None else 1] <= steps).all())
    assert bool((steps > 0).any())


@pytest.mark.parametrize("q", [1, 2, 8])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("table", TABLES)
def test_queue_order_equals_scan_order(cases, table, any_hit, q):
    args, two, (hit, cnt) = cases[(table, any_hit)]
    got, qcnt = _queue(args, two, any_hit, q)
    for k in hit:
        assert torch.equal(got[k], hit[k]), k
    # K4: warp steps, rows tested; K5: superclusters entered, group fills,
    # rows fetched, rows tested
    shared = 4 if two is not None else 2
    assert torch.equal(qcnt[:, :shared], cnt[:, :shared])
    passes = qcnt[:, -1]
    assert bool((passes >= 1).all())
    if q == 1:   # a queue of one pair runs dry: lanes make more passes
        assert bool((passes > 1).any())
    if two is not None:   # a lane transforms for the rows it tests only
        assert bool((qcnt[:, 4] <= qcnt[:, 3]).all())
        assert int(qcnt[:, 4].sum()) < int(cnt[:, 4].sum())


def _shared_origin_rays(table, rng, n=1024):
    """Warps of 32 lanes leaving one point each, a point inside two
    overlapping cluster boxes, in random directions, window from 0: each
    such lane enters both boxes at entry 0, so the warp's picks meet ties
    in entry broken by the id."""
    ds, ct, gmax, _ = _table(table)
    b = ds["cluster_bounds"].numpy()
    lo = np.maximum(b[:, None, :3], b[None, :, :3])
    hi = np.minimum(b[:, None, 3:], b[None, :, 3:])
    i, j = np.nonzero(np.triu(np.all(hi - lo > 1e-3, axis=-1), 1))
    k = rng.integers(0, len(i), n // 32)
    pts = rng.uniform(lo[i[k], j[k]], hi[i[k], j[k]]).astype(np.float32)
    o = torch.tensor(np.repeat(pts, 32, axis=0))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    args = (ds["cluster_bounds"], ds["cluster_table"], ct, o, d,
            torch.zeros(n), torch.full((n,), 1e30),
            torch.ones(n, dtype=torch.int32))
    return args, ((ds["sc_bounds"], gmax) if gmax else None)


@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("table", ["volume_sss", "big_instanced"])
def test_ties_in_entry_are_broken_by_the_id(table, any_hit, q):
    rng = np.random.default_rng(40)
    args, two = _shared_origin_rays(table, rng)
    if any_hit:
        args = args[:6] + (torch.full((args[3].shape[0],), 300.0),) \
            + args[7:]
    # the tie is reached: in every warp the least entry (0) is shared by
    # at least two clusters
    entry = ci.entry_table(*args[:1], *args[3:7]).view(
        args[0].shape[0], -1, 32)
    first = entry.amin((0, 2))
    assert bool((first == 0.0).all())
    assert bool(((entry == first[None, :, None]).any(2).sum(0) >= 2).all())
    hit, cnt = _scan(args, two, any_hit)
    _held_to_plain(args, two, any_hit, hit)
    got, qcnt = _queue(args, two, any_hit, q)
    for k in hit:
        assert torch.equal(got[k], hit[k]), k
    shared = 4 if two is not None else 2
    assert torch.equal(qcnt[:, :shared], cnt[:, :shared])
