"""K6's visit order (ops/onehot2_walk.py) in its two plain torch mirrors,
on the CPU:

- the scan-order mirror (onehot2_scan_order: the first design, a (SC, 32)
  supercluster table scanned for every pick and a rescan of the group's
  boxes for every visit) against the plain walk ops/cluster_intersect.py
  intersect_clusters: hit masks equal; t, u, v, prim and object equal
  except where two triangles are hit at the same t (the walks' visit
  orders differ); any hit: the blocked masks equal;
- the queue-order mirror (onehot2_queue_order: the kernel's design,
  per-lane queues of Q (entry, supercluster) pairs and a retired bitmask,
  one box pass per group into a queue of GQ packed keys, refilled when it
  runs dry while a key fell off) against the scan-order mirror, for every
  Q and GQ of 2, 4 and 8: every output equal on every lane, exact-t ties
  included, and so are the superclusters entered, groups walked, rows read
  and rows tested; the warp's inner steps equal; a lane transforms its ray
  at most once a row it reads, and makes a box pass at least once a group
  it walks.

Inputs: big_instanced's two-level tables with instance rows (1,025
clusters in 65 superclusters, the port's own host compile) under camera
rays and seeded random rays; a synthetic two-level table whose clusters
share one box a group and whose supercluster boxes overlap, under rays
that leave one point inside two superclusters a warp (every entry ties:
both levels break ties by the id); and one of 64-cluster groups, so that
a lane's group holds more keys than a queue of 2 or 4 and a refill runs.
The CUDA kernel is held to these mirrors on the card
(tests/test_torch_onehot2_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.app import examples
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import onehot2_walk as k6

torch.set_num_threads(1)
N = 1024
TABLES = ("big_random", "big_camera", "ties", "refill")
QUEUES = (2, 4, 8)


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True))


@functools.lru_cache(maxsize=None)
def _big():
    s = examples.instanced_scene(16, 16, spp=2, grid=8)
    s.device_update()
    kg = s.make_kernel_globals("cpu")
    ds = kg["dscene"]
    return kg, (ds["sc_bounds"], ds["cluster_bounds"], ds["cluster_table"],
                int(kg["cluster_tris"]), int(kg["sc_gmax"]))


def _camera_rays(kg, side=32):
    """Pixel-center camera rays of a side x side film over the scene's
    camera."""
    cam = kg["cam"]
    s = float(cam["width"]) / side
    yy, xx = np.mgrid[0:side, 0:side]
    rx = torch.tensor((xx.reshape(-1) + 0.5) * s, dtype=torch.float32)
    ry = torch.tensor((yy.reshape(-1) + 0.5) * s, dtype=torch.float32)
    z = torch.zeros_like(rx)
    ray = cam_ops.camera_sample_ray(cam, rx, ry, z, z, z)
    return ray["o"].contiguous(), ray["d"].contiguous()


def _shared_origins(tabs, rng):
    """Warps of 32 lanes leaving one point each, inside the overlap of two
    supercluster boxes, window from 0: every lane enters both at 0."""
    b = tabs[0][:, :6].numpy()
    lo = np.maximum(b[:, None, :3], b[None, :, :3])
    hi = np.minimum(b[:, None, 3:], b[None, :, 3:])
    i, j = np.nonzero(np.triu(np.all(hi - lo > 1e-3, axis=-1), 1))
    k = rng.integers(0, len(i), N // 32)
    pts = rng.uniform(lo[i[k], j[k]], hi[i[k], j[k]]).astype(np.float32)
    return torch.tensor(np.repeat(pts, 32, axis=0)), _dirs(rng, N)


def _input(table, any_hit):
    """(the mirrors' ten positional arguments) for one case."""
    rng = np.random.default_rng(50 + 2 * TABLES.index(table) + any_hit)
    tmin = torch.full((N,), 1e-4)
    if table.startswith("big"):
        kg, tabs = _big()
        span = 20.0
        if table == "big_camera":
            o, d = _camera_rays(kg)
            tmin = torch.zeros(N)
        else:
            o = torch.tensor(rng.uniform(-span, span, (N, 3))
                             .astype(np.float32))
            d = _dirs(rng, N)
    elif table == "ties":
        tabs = (*k6.grid_tables2(8, 12, 4, rng, pitch=60.0,
                                 shared_box=True), 4, 12)
        o, d = _shared_origins(tabs, rng)
        tmin = torch.zeros(N)
        span = 140.0
    else:
        tabs = (*k6.grid_tables2(8, 64, 4, rng), 4, 64)
        span = 180.0
        o = torch.tensor(rng.uniform(-0.25 * span, 1.25 * span, (N, 3))
                         .astype(np.float32))
        d = _dirs(rng, N)
    if any_hit:
        tmax = torch.tensor(np.where(rng.uniform(size=N) < 0.5,
                                     rng.uniform(1.0, span, N), 1e30)
                            .astype(np.float32))
    else:
        tmax = torch.full((N,), 1e30)
    return (*tabs, o, d, tmin, tmax, torch.ones(N, dtype=torch.int32))


@pytest.fixture(scope="module")
def cases():
    """{(table, any_hit): (args, the scan mirror's (hit, counts, warp
    steps))}, the scan mirror run once per case."""
    out = {}
    for table in TABLES:
        for any_hit in (False, True):
            args = _input(table, any_hit)
            out[(table, any_hit)] = (args, k6.onehot2_scan_order(
                *args, shadow_any_hit=any_hit, has_instances=True))
    return out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("table", TABLES)
def test_scan_order_against_the_plain_walk(cases, table, any_hit):
    args, (hit, cnt, steps) = cases[(table, any_hit)]
    ref = ci.intersect_clusters(*args[1:4], *args[5:],
                                shadow_any_hit=any_hit, has_instances=True)
    assert torch.equal(hit["prim"] >= 0, ref["prim"] >= 0)
    assert bool((ref["prim"] >= 0).any())
    if not any_hit:
        same = (hit["prim"] == ref["prim"]) & (hit["object"] == ref["object"])
        # the ties table's triangles lie at random in one cube a group, so
        # no two share a t there either
        assert (~same).float().mean().item() <= 1e-3
        for k in ("t", "u", "v"):
            assert torch.equal(hit[k][same], ref[k][same]), k
        torch.testing.assert_close(hit["t"][~same], ref["t"][~same],
                                   rtol=1e-6, atol=1e-4)
    # every lane of a warp counts its warp's superclusters and steps; a
    # lane walks at most the groups its warp entered and reads at most the
    # rows its warp stepped through
    for x in (cnt[:, 0], steps):
        assert bool((x.view(-1, 32) == x.view(-1, 32)[:, :1]).all())
    assert bool((cnt[:, 1] <= cnt[:, 0]).all())
    assert bool((cnt[:, 4] <= steps).all()) and bool((cnt[:, 4] > 0).any())
    assert bool((cnt[:, 5] <= cnt[:, 4]).all())
    assert torch.equal(cnt[:, 6], cnt[:, 4])   # a transform every row
    assert torch.equal(cnt[:, 7], cnt[:, 0] + 1)


@pytest.mark.parametrize("gq", QUEUES)
@pytest.mark.parametrize("q", QUEUES)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("table", TABLES)
def test_queue_order_equals_scan_order(cases, table, any_hit, q, gq):
    args, (hit, cnt, steps) = cases[(table, any_hit)]
    got, qcnt, qsteps = k6.onehot2_queue_order(
        *args, shadow_any_hit=any_hit, has_instances=True, queue=q,
        gqueue=gq)
    for k in hit:
        assert torch.equal(got[k], hit[k]), k
    shared = list(k6.SHARED_COUNTS)
    assert torch.equal(qcnt[:, shared], cnt[:, shared])
    assert torch.equal(qsteps, steps)
    # a lane transforms only for rows it tests, and makes a box pass at
    # least once a group it walks; the rescan made one a visit
    assert bool((qcnt[:, 6] <= qcnt[:, 4]).all())
    assert bool((qcnt[:, 3] >= qcnt[:, 1]).all())
    assert bool((qcnt[:, 3] <= cnt[:, 3]).all())
    assert int(qcnt[:, 6].sum()) < int(cnt[:, 6].sum())
    assert bool((qcnt[:, 7] >= 1).all())
    if table == "refill" and gq < 8:   # groups of 64 outgrow the queue
        assert bool((qcnt[:, 3] > qcnt[:, 1]).any())


def test_ties_are_reached():
    """On the ties table every warp's least supercluster entry (0) is
    shared by two superclusters, and a lane that walks a group meets all
    its clusters at one entry."""
    args = _input("ties", False)
    scb, cb = args[0], args[1]
    o, d, tmin, tmax = args[5:9]
    e = ci.entry_table(scb[:, :6], o, d, tmin, tmax).view(scb.shape[0], -1,
                                                           32)
    first = e.amin((0, 2))
    assert bool((first == 0.0).all())
    assert bool(((e == first[None, :, None]).any(2).sum(0) >= 2).all())
    ce = ci.entry_table(cb, o, d, tmin, tmax).view(-1, 12, N)
    inside = (ce < ci.INF).any(1)
    assert bool(inside.any())
    assert bool(((ce == ce.amin(1, keepdim=True)).all(1) | ~inside).all())


def test_wrapper_counts_are_the_kernels():
    """counts=True is the kernel's counting variant: a CPU tensor raises,
    as K5's wrapper does."""
    args = _input("refill", False)
    with pytest.raises(NotImplementedError, match="kernel"):
        k6.intersect_clusters2_onehot(*args, has_instances=True, counts=True)
    assert len(k6.COUNTS) == 8 and k6.SC_QUEUE == 8 and k6.G_QUEUE == 8
