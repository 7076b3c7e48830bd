"""K4: the tile-shared cluster walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_cluster.py intersect_clusters_pallas).

`intersect_clusters_tile` has the contract of the plain walk
ops/cluster_intersect.py `intersect_clusters`, which is its plain version
(K2 shares it). A CPU tensor takes the plain version; a CUDA tensor
launches the hand-written kernel csrc/tile_walk.cu or raises. The kernel
walks a warp of 32 rays together, one cluster per step: the lexicographic
minimum (entry, cluster) over the lanes' smallest unretired entries below
their gates, tested by every lane whose own entry is below its gate, then
retired for the warp. So prim and object may differ from the plain
version's at exact-t ties between clusters (and there t by an ulp, where
the two hits are coplanar triangles); hit masks agree, and t, u and v on
every lane whose prim and object do.
`launches` counts kernel launches. It takes single-level tables up to the
JAX package's single-level cap, MAX_CLUSTERS (640), with or without
instance rows (has_instances: a lane's ray is taken to the row's object
space before the row's triangle tests; the boxes are world boxes, so the
visit order needs nothing more), or with motion rows (has_motion: each
lane tests the row's triangles lerped to its time; the boxes cover both
shutter ends, so again the visit order needs nothing more); motion rows
with instance rows raise. With counts=True the
counting variant runs and the call also returns (N, 4) int32 counts per
lane: the rows its warp fetched (steps), the rows the lane tested, the
cluster boxes it tested, and its box passes (CUDA tensors only).

Two plain torch mirrors of the warp's visit order, for the tests and the
checks on the card (never a render path), fix the kernel's design:
`tile_scan_order` emulates the earlier design (a (C, 32) entry table
scanned on every step), `tile_queue_order` the kernel's (per-lane sorted
queues of QUEUE (entry, cluster) pairs, a warp minimum over their heads, a
per-warp retired bitmask, a box pass whenever a lane's queue runs dry and
a pair fell off its end). Both pick the same cluster on every step, so
every output and step count is equal; the kernel's outputs are the scan
mirror's and its counts the queue mirror's, to the lane.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk as cw
from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.utils.math import RAY_TMAX

launches = 0

MAX_CLUSTERS = 640   # the JAX package's single-level cap
TILE = 32            # lanes of a warp: the tile that shares a walk
QUEUE = 12           # K4_QUEUE of csrc/tile_walk.cu
INF = ci.INF
NO_ID = 0x7FFFFFFF   # the id of an empty slot of LaneQueues


def intersect_clusters_tile(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                            visibility, shadow_any_hit=False,
                            has_instances=False, time=None,
                            has_motion=False, counts=False):
    """Closest hit (or any hit) over the cluster tables; returns dict
    t, u, v (f32) and prim, object (int32), (N,) each; with counts=True
    (hit dict, (N, 4) int32 counts: the steps of the lane's warp, the rows
    the lane tested, its box tests and its box passes)."""
    global launches
    cw.no_motion_instances(has_instances, has_motion)
    if o.device.type == "cpu":
        if counts:
            raise NotImplementedError("visit counts come from the kernel")
        return ci.intersect_clusters(cbounds, ctable, cluster_tris, o, d,
                                     tmin, tmax, visibility,
                                     shadow_any_hit=shadow_any_hit,
                                     has_instances=bool(has_instances),
                                     time=time, has_motion=bool(has_motion))
    time = ci.lane_time(time, o.shape[0], has_motion, o.device)
    n, c, w = cw.check_walk_args(cbounds, ctable, cluster_tris, o, d, tmin,
                                 tmax, visibility, max_clusters=MAX_CLUSTERS,
                                 time=time)
    dev = o.device
    cnt = torch.empty((n, 4), dtype=torch.int32, device=dev) \
        if counts else None
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    obj = torch.empty(n, dtype=torch.int32, device=dev)
    rc = kernels.load().rt_tile_walk(
        cbounds.data_ptr(), ctable.data_ptr(), c, w, int(cluster_tris),
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        visibility.data_ptr(), n, int(bool(shadow_any_hit)),
        int(bool(has_instances)), int(time is not None),
        time.data_ptr() if time is not None else None, t.data_ptr(),
        prim.data_ptr(), u.data_ptr(),
        v.data_ptr(), obj.data_ptr(), cnt.data_ptr() if counts else None,
        kernels.current_stream())
    kernels.check_rc("tile_walk", rc)
    launches += 1
    hit = {"t": t, "prim": prim, "u": u, "v": v, "object": obj}
    return (hit, cnt) if counts else hit


# ---- the plain mirrors of the warp's visit order ----

def pad_lanes(o, d, tmin, tmax, visibility, time=None):
    """The lanes padded to whole warps with the kernel's values for lanes
    past n (origin 0, direction +x, window [0, -1], visibility 0, time
    0); returns (o, d, tmin, tmax, visibility, live) and, when time is
    given, the padded time after them."""
    n = o.shape[0]
    pad = -n % TILE
    live = torch.ones(n + pad, dtype=torch.bool, device=o.device)
    if time is not None:
        tp = torch.cat([time, time.new_zeros(pad)])
        return pad_lanes(o, d, tmin, tmax, visibility) + (tp,)
    if not pad:
        return o, d, tmin, tmax, visibility.to(torch.int32), live
    live[n:] = False
    z = torch.zeros((pad, 3), dtype=o.dtype, device=o.device)
    dx = z.clone()
    dx[:, 0] = 1.0
    return (torch.cat([o, z]), torch.cat([d, dx]),
            torch.cat([tmin, z[:, 0]]), torch.cat([tmax, z[:, 0] - 1.0]),
            torch.cat([visibility.to(torch.int32),
                       z[:, 0].to(torch.int32)]), live)


def new_hit(tmax):
    """A walk's running result: t = min(tmax, RAY_TMAX), no hit."""
    n, dev = tmax.shape[0], tmax.device
    return {"t": torch.clamp(tmax, max=RAY_TMAX),
            "u": torch.zeros(n, device=dev), "v": torch.zeros(n, device=dev),
            "prim": torch.full((n,), -1, dtype=torch.int32, device=dev),
            "object": torch.full((n,), -1, dtype=torch.int32, device=dev)}


def lane_gate(hit, any_hit):
    """Each lane's gate: entries below its best t; none (-INF) once an
    any-hit lane has its hit."""
    if any_hit:
        return torch.where(hit["prim"] >= 0, -INF, hit["t"])
    return hit["t"]


def row_test(ctable, ct, cid, test, ws, tmin, visibility, hit,
             o=None, d=None, time=None):
    """Every lane where `test` holds tests the triangles of row cid[lane]
    in order with strict t < best (the kernels' sequential update, which
    is the first minimum of the masked t); updates `hit` in place. With o
    and d (instance rows) the lane's ray is first taken to the row's
    object space; ws is the lanes' (N, 1) shear basis otherwise. With
    time (motion rows) the triangles are lerped to the lane's time."""
    idx = test.nonzero()[:, 0]
    if idx.numel() == 0:
        return
    rows = ctable[cid[idx]]
    if o is not None:
        wsi = ci._lane_ws(*ci._row_w2o_ray(rows, o[idx], d[idx]))
    else:
        wsi = {k: (tuple(x[idx] for x in v) if isinstance(v, tuple)
                   else v[idx]) for k, v in ws.items()}
    v0c, e1c, e2c = ci._row_tris(rows, ct,
                                 None if time is None else time[idx])
    valid, t, u, v = isect.wt_block(wsi, v0c, e1c, e2c, tmin[idx, None],
                                    hit["t"][idx, None])
    pbase = ci.prim_col(ct, time is not None)
    pid = rows[:, pbase:pbase + ct]
    tri_vis = rows[:, pbase + 2 * ct:pbase + 3 * ct].to(torch.int32)
    ok = valid & (pid >= 0.0) & ((tri_vis & visibility[idx, None]) != 0)
    tk, k = torch.where(ok, t, float("inf")).min(1)
    got = ok.any(1)
    j, r, k = idx[got], got.nonzero()[:, 0], k[got]
    hit["t"][j] = tk[got]
    hit["prim"][j] = pid[r, k].to(torch.int32)
    hit["u"][j] = u[r, k]
    hit["v"][j] = v[r, k]
    hit["object"][j] = rows[r, pbase + ct + k].to(torch.int32)


def warp_min(e, c, no_id):
    """Per warp the lexicographic minimum (entry, id) over its lanes' (e,
    c) (lanes in order, TILE a warp): returns (entry (W,), id (W,))."""
    ew = e.view(-1, TILE)
    m = ew.amin(1)
    cm = torch.where(ew == m[:, None], c.view(-1, TILE), no_id).amin(1)
    return m, cm


def table_pick(entry, ok):
    """The earlier design's pick: per warp the lexicographic minimum
    (entry, index) over the (K, N) table where `ok`; returns (entry (W,),
    index (W,))."""
    k = entry.shape[0]
    m = torch.where(ok, entry, INF).view(k, -1, TILE)
    me = m.amin((0, 2))
    hit_k = (m == me[None, :, None]).any(2)
    ids = torch.arange(k, device=entry.device)[:, None]
    return me, torch.where(hit_k, ids, k).amin(0)


class LaneQueues:
    """Per lane the sorted queue of the Q smallest (entry, id) pairs of
    its last box pass (csrc/pair_queue.cuh), the last pair it dropped and
    whether a pair fell off the end at that pass."""

    def __init__(self, n, q, live):
        dev = live.device
        self.q = q
        self.e = torch.full((n, q), INF, device=dev)
        self.c = torch.full((n, q), NO_ID, dtype=torch.long, device=dev)
        self.last_e = torch.full((n,), -INF, device=dev)
        self.last_c = torch.full((n,), -1, dtype=torch.long, device=dev)
        self.fell = live.clone()   # the first step makes the first pass

    def head(self, lanes, entry, retired, warp, gate, passes, boxes):
        """One step's queue work for the lanes in `lanes`: drop the head
        pairs that are retired (retired[id, warp]) or not below the gate,
        and where the queue ran dry, a pair fell off at the last pass and
        the last dropped pair lies below the gate, make a box pass over
        the unretired ids of the (K, N) table `entry`: the Q smallest
        pairs above the last dropped one, unretired and below the gate.
        Counts passes and box tests (one per unretired id) per lane.
        Returns each lane's head (entry, id); (INF, NO_ID) where empty or
        not in `lanes`."""
        k, q = entry.shape[0], self.q
        real = self.c != NO_ID
        ret = retired[self.c.clamp(max=k - 1), warp[:, None]]
        valid = real & ~ret & (self.e < gate[:, None])
        first = torch.where(valid.any(1), valid.to(torch.int8).argmax(1), q)
        drop = torch.where(lanes, torch.minimum(first, real.sum(1)), 0)
        dropped = drop > 0
        li = (drop - 1).clamp(min=0)[:, None]
        self.last_e = torch.where(dropped, self.e.gather(1, li)[:, 0],
                                  self.last_e)
        self.last_c = torch.where(dropped, self.c.gather(1, li)[:, 0],
                                  self.last_c)
        src = torch.arange(q, device=entry.device)[None] + drop[:, None]
        inq = src < q
        self.e = torch.where(inq, self.e.gather(1, src.clamp(max=q - 1)),
                             INF)
        self.c = torch.where(inq, self.c.gather(1, src.clamp(max=q - 1)),
                             NO_ID)
        need = lanes & (self.c[:, 0] == NO_ID) & self.fell \
            & (self.last_e < gate)
        if bool(need.any()):
            idx = need.nonzero()[:, 0]
            unret = ~retired[:, warp[idx]]
            passes[idx] += 1
            boxes[idx] += unret.sum(0)
            e = entry[:, idx] + 0.0   # -0.0 sorts as +0.0, as compared
            ids = torch.arange(k, device=e.device)[:, None]
            le, lc = self.last_e[idx], self.last_c[idx]
            cand = unret & (e < gate[idx]) & (
                (e > le) | ((e == le) & (ids > lc)))
            se, order = torch.sort(torch.where(cand, e, INF), dim=0,
                                   stable=True)
            m = min(q, k)
            ne = torch.full((q, idx.numel()), INF, device=e.device)
            nc = torch.full((q, idx.numel()), NO_ID, dtype=torch.long,
                            device=e.device)
            ne[:m] = se[:m]
            nc[:m] = torch.where(se[:m] < INF, order[:m], NO_ID)
            self.e[idx] = ne.T
            self.c[idx] = nc.T
            self.fell[idx] = cand.sum(0) > q
        he = torch.where(lanes, self.e[:, 0], INF)
        hc = torch.where(lanes, self.c[:, 0], NO_ID)
        return he, hc


def _tile_order(cbounds, ctable, cluster_tris, o, d, tmin, tmax, visibility,
                shadow_any_hit, queue, has_instances=False, time=None,
                has_motion=False):
    n, c = o.shape[0], cbounds.shape[0]
    time = ci.lane_time(time, n, has_motion, o.device)
    o, d, tmin, tmax, vis, live, *tp = pad_lanes(o, d, tmin, tmax,
                                                 visibility, time)
    time = tp[0] if tp else None
    dev, lanes_n = o.device, o.shape[0]
    warp = torch.arange(lanes_n, device=dev) // TILE
    nw = lanes_n // TILE
    entry = ci.entry_table(cbounds, o, d, tmin, tmax)
    entry[:, ~live] = INF
    hit = new_hit(tmax)
    ws = ci._lane_ws(o, d)
    retired = torch.zeros((c, nw), dtype=torch.bool, device=dev)
    running = torch.ones(nw, dtype=torch.bool, device=dev)
    cnt = torch.zeros((lanes_n, 4), dtype=torch.long, device=dev)
    queues = LaneQueues(lanes_n, queue, live) if queue else None
    for _ in range(c):
        gate = lane_gate(hit, shadow_any_hit)
        on = running[warp]
        if queues is None:
            cnt[:, 2] += on * c   # the table scan of the pick
            me, mc = table_pick(entry, (entry < gate[None]) & ~retired[:, warp]
                                & on[None])
        else:
            he, hc = queues.head(on, entry, retired, warp, gate,
                                 cnt[:, 3], cnt[:, 2])
            me, mc = warp_min(he, hc, NO_ID)
        running = running & (me < INF)
        if not bool(running.any()):
            break
        on = running[warp]
        cl = mc[warp].clamp(max=c - 1)
        test = on & (entry[cl, torch.arange(lanes_n, device=dev)] < gate)
        if queues is not None:
            cnt[:, 2] += on   # the slab test of the picked cluster
        cnt[:, 1] += test
        row_test(ctable, cluster_tris, cl, test, ws, tmin, vis, hit,
                 *((o, d) if has_instances else (None, None)), time=time)
        wi = running.nonzero()[:, 0]
        retired[mc[wi], wi] = True
        cnt[:, 0] += on
    out = {k: x[:n] for k, x in hit.items()}
    cnt = cnt[:n].to(torch.int32)
    return out, (cnt if queue else cnt[:, :3])


def tile_scan_order(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                    visibility, shadow_any_hit=False, has_instances=False,
                    time=None, has_motion=False):
    """K4's earlier design as plain torch: lanes in warps of 32 in index
    order; each step every lane scans its column of the (C, 32) entry
    table for its first smallest unretired entry below its gate, the warp
    takes the lexicographic minimum (entry, cluster), every lane whose
    own entry is below its gate tests that row, and the cluster is
    retired for the warp. With has_instances a lane tests a row with its
    ray taken to the row's object space (boxes are world boxes: the picks
    need nothing more); with has_motion at the lane's time. Returns (hit
    dict, (N, 3) int32: the steps of the lane's warp, the rows the lane
    tested, the entries its picks read, C a pick)."""
    return _tile_order(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                       visibility, shadow_any_hit, None, has_instances,
                       time, has_motion)


def tile_queue_order(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                     visibility, shadow_any_hit=False, queue=QUEUE,
                     has_instances=False, time=None, has_motion=False):
    """K4's kernel as plain torch: the same warp walk, with each lane's
    pick taken from its queue of `queue` pairs (LaneQueues.head) and a
    retired bitmask per warp; every lane then tests its box of the picked
    cluster against its gate. Returns (hit dict, (N, 4) int32: the steps
    of the lane's warp, the rows the lane tested, its box tests, its box
    passes): the counts of intersect_clusters_tile(counts=True)."""
    return _tile_order(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                       visibility, shadow_any_hit, int(queue), has_instances,
                       time, has_motion)


def grid_tables(c, ct, rng, device="cpu"):
    """A single-level table of c clusters of ct random triangles: cluster
    k's triangles lie in a cube of side 20 on a grid of pitch 30, its
    boundary flags are random. Returns (cbounds, ctable, cboundary)."""
    side = int(np.ceil(c ** (1.0 / 3.0)))
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)[:c] * 30.0
    verts = (cells[:, None, None, :]
             + rng.uniform(0.0, 20.0, (c, ct, 3, 3))).astype(np.float32)
    clusters = [{"verts": verts[k], "prim": np.arange(k * ct, (k + 1) * ct),
                 "obj": np.full(ct, k % 7, np.int32),
                 "vis": np.full(ct, 255, np.int32),
                 "lo": verts[k].reshape(-1, 3).min(0),
                 "hi": verts[k].reshape(-1, 3).max(0)} for k in range(c)]
    cb, ctab, _ = ci.pack_cluster_table(clusters)
    cbd = (rng.uniform(size=(c, ct)) < 0.3).astype(np.float32)
    return (torch.tensor(cb, device=device), torch.tensor(ctab, device=device),
            torch.tensor(cbd, device=device))
