"""K6: the two-level walk with a per-lane inner walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_onehot.py intersect_clusters2_onehot).

`intersect_clusters2_onehot` takes K5's arguments (ops/cluster2_walk.py):
the supercluster table sc_bounds (SC, 8) and its group size gmax beside
the f32 cluster tables. The JAX package's bf16x3 group tables (oh2_*,
pack_onehot2_tables) are not built: they feed the TPU's matrix unit, and
the kernel reads the f32 rows directly. What is kept of that packing is
its capacity rule: gmax <= G_PAD (128 clusters per supercluster), which
the kernel needs too, and the packing's VMEM estimate, which grows with
the supercluster count and the row width; `fits(gmax, sc, w)` states
both, and the integrator falls back to K5 where it fails, as the JAX
package does when its packing declines.

The contract is the plain walk's, ops/cluster_intersect.py
`intersect_clusters` over all C clusters (the JAX package's own reference
for this kernel), which is the plain version. A CPU tensor takes the
plain version; a CUDA tensor launches the hand-written kernel
csrc/onehot2_walk.cu or raises. The outer level is shared by a warp of 32
rays and each lane walks a picked group's clusters in its own order, so
prim and object may differ from the plain version's at exact-t ties
between clusters; hit masks, t, u and v agree. Motion rows
(has_motion) are tested at each lane's time (time (N,) f32; zeros when
None), as K5 tests them; motion rows with instance rows raise.
`launches` counts kernel launches. With counts=True the counting variant
runs and the call also returns (N, 8) int32 counts per lane (CUDA tensors
only), the columns of COUNTS.

Two plain torch mirrors of the visit order, for the tests and the checks
on the card (never a render path), fix the kernel's design:
`onehot2_scan_order` emulates the first design (a (SC, 32) supercluster
entry table scanned on every pick; in a group, a rescan of its boxes for
every visit; every row a w2o transform), `onehot2_queue_order` the
kernel's (per-lane queues of SC_QUEUE (entry, supercluster) pairs and a
retired bitmask, as K5's; in a group one box pass into a queue of
G_QUEUE packed keys, refilled above the last key when it runs dry while
a key fell off; a transform only at a row the lane tests whose w2o
differs from the last one it used). Both visit the same rows in the same
order, so every output is equal on every lane, and so are the columns of
SHARED_COUNTS. Both take the lanes' times with motion rows.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_walk as cw
from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.ops import tile_walk as tw
from raytracingproject_tpu_torch.ops.cluster2_walk import (
    SMEM_BYTES, TILE, launch_two_level)

launches = 0

G_PAD = 128   # clusters per supercluster the inner walk takes
SC_QUEUE = 8  # K6_QUEUE of csrc/onehot2_walk.cu
G_QUEUE = 8   # K6_GQUEUE of csrc/onehot2_walk.cu
# the per-lane counts of the counting variant and of both mirrors
COUNTS = ("superclusters entered", "groups walked", "group box tests",
          "group passes", "rows read", "rows tested", "transforms",
          "supercluster passes")
SHARED_COUNTS = (0, 1, 4, 5)   # the columns equal in both designs
KEY_ID_BITS = 9                # watertight.cuh RT_KEY_ID_BITS
NO_KEY = 0xFFFFFFFF            # watertight.cuh RT_NO_KEY
KEY_NEG = 0x80000000           # watertight.cuh RT_KEY_NEG


def fits(gmax, sc=0, w=0):
    """Whether two-level tables of sc superclusters with groups of up to
    gmax clusters, rows w floats wide, are within K6's capacity: the
    kernel's inner walk takes gmax <= G_PAD, and the JAX package packs
    its group tables only while twice its inner working set at a tile of
    1,024 lanes, (4 sc + 4 G_PAD + 4 w_pad + 6 w_pad / 128 + 1024) x
    1024 bytes (w padded to 16), fits its VMEM budget
    (ops/pallas_onehot.py pack_onehot2_tables). sc = w = 0 asks for the
    kernel's own limit alone."""
    if not 0 < int(gmax) <= G_PAD:
        return False
    w_pad = -(-int(w) // 16) * 16
    est = (int(sc) * 4 + G_PAD * 4 + w_pad * 4 + w_pad * 2 * 3 // 128
           + 1024) * 1024
    return est * 2 <= cw.VMEM_BUDGET


def smem_per_warp(sc):
    """The capacity rule K6 keeps from its first design, which held a
    (SC, 32) supercluster entry table and one group's bounds per warp.
    The queue design needs less (the supercluster table once a block,
    then per warp the group's bounds), so every table the rule admits
    launches, and the dispatch refuses what it refused before."""
    return (sc * TILE + G_PAD * 6) * 4


def intersect_clusters2_onehot(sc_bounds, cbounds, ctable, cluster_tris, gmax,
                               o, d, tmin, tmax, visibility,
                               shadow_any_hit=False, has_instances=False,
                               has_motion=False, time=None, counts=False):
    """Closest hit (or any hit) over the two-level cluster tables;
    returns dict t, u, v (f32) and prim, object (int32), (N,) each; with
    counts=True (hit dict, (N, 8) int32 counts, the columns of COUNTS)."""
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
    kernels.unsupported(
        fits(gmax), f"gmax {gmax}: the inner walk takes groups of 1..{G_PAD}")
    kernels.unsupported(
        smem_per_warp(sc_bounds.shape[0]) <= SMEM_BYTES,
        f"the SC {sc_bounds.shape[0]} entry table does not fit one warp's "
        "shared memory")
    cnt = torch.empty((o.shape[0], len(COUNTS)), dtype=torch.int32,
                      device=o.device) if counts else None
    out = launch_two_level("rt_onehot2_walk", sc_bounds, cbounds, ctable,
                           cluster_tris, gmax, o, d, tmin, tmax, visibility,
                           shadow_any_hit, has_instances,
                           ci.lane_time(time, o.shape[0], has_motion,
                                        o.device),
                           (cnt.data_ptr() if counts else None,))
    launches += 1
    return (out, cnt) if counts else out


# ---- the plain mirrors of the visit order ----

def _keys(e, gids):
    """The packed keys (watertight.cuh rt_pack_key) of entries e (K, G)
    and local ids gids (G,), as int64 in [0, 2^32), and each key's
    truncated entry (rt_key_entry) as float32."""
    bits = (e + 0.0).view(torch.int32) & ~((1 << KEY_ID_BITS) - 1)
    key = (bits.to(torch.int64) & 0xFFFFFFFF) | gids
    return key, bits.view(torch.float32)


def _key_entry(key):
    """rt_key_entry of int64 keys in [0, 2^32)."""
    k = key & ~((1 << KEY_ID_BITS) - 1)
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(
        torch.int32).view(torch.float32)


class _GroupWalk:
    """The lanes `idx` walking one group each: their keys (K, gmax) in the
    group (NO_KEY past its gcount or on a miss), truncated entries, last
    visited key, and with a queue of `gq` keys the queue and the fell-off
    flags of K2's walk (csrc/cluster_walk.cu)."""

    def __init__(self, idx, key, ent, gq):
        k, dev = idx.numel(), idx.device
        self.idx, self.key, self.ent, self.gq = idx, key, ent, gq
        self.last = torch.full((k,), -1, dtype=torch.int64, device=dev)
        self.done = torch.zeros(k, dtype=torch.bool, device=dev)
        if gq:
            self.q = torch.full((k, gq), NO_KEY, dtype=torch.int64,
                                device=dev)
            self.fell_pos = torch.ones(k, dtype=torch.bool, device=dev)
            self.fell_neg = torch.zeros(k, dtype=torch.bool, device=dev)

    def scan_step(self, gate, step, gcount, cnt):
        """The first design's visit: a rescan of the group's boxes for the
        smallest live key (at most gcount visits). Returns (rows, keys) of
        the lanes that visit."""
        rows = (~self.done & (step < gcount)).nonzero()[:, 0]
        lanes = self.idx[rows]
        cnt[lanes, 2] += gcount[rows]
        cnt[lanes, 3] += 1
        cand = (self.key[rows] != NO_KEY) \
            & (self.key[rows] > self.last[rows, None]) \
            & (self.ent[rows] < gate[rows, None])
        best = torch.where(cand, self.key[rows], NO_KEY).amin(1)
        found = cand.any(1)
        self.done[rows[~found]] = True
        self.done[(~self.done & (step + 1 >= gcount))] = True
        rows, best = rows[found], best[found]
        return rows, best

    def queue_step(self, gate_of, gcount, cnt):
        """The kernel's visit: drop culled heads, pass when the queue ran
        dry while a key fell off, pop the head. `gate_of(rows)` gives the
        lanes' gates now. Returns (rows, keys) of the lanes that visit."""
        while True:
            rows = (~self.done).nonzero()[:, 0]
            if rows.numel() == 0:
                return rows, rows
            gate = gate_of(rows)
            while True:   # drop culled heads
                head = self.q[rows, 0]
                cull = (head != NO_KEY) & (_key_entry(head) >= gate)
                if not bool(cull.any()):
                    break
                r = rows[cull]
                self.fell_pos[r[(head[cull] & KEY_NEG) == 0]] = False
                self.q[r] = torch.cat([self.q[r, 1:], torch.full_like(
                    self.q[r, :1], NO_KEY)], 1)
            empty = self.q[rows, 0] == NO_KEY
            go = empty & (self.fell_pos[rows] | self.fell_neg[rows])
            self.done[rows[empty & ~go]] = True
            if not bool(go.any()):
                keep = ~self.done[rows]
                rows = rows[keep]
                head = self.q[rows, 0]
                self.q[rows] = torch.cat([self.q[rows, 1:], torch.full_like(
                    self.q[rows, :1], NO_KEY)], 1)
                return rows, head
            r = rows[go]
            lanes = self.idx[r]
            cnt[lanes, 2] += gcount[r]
            cnt[lanes, 3] += 1
            # the pass: keys above the last visited, below the gate
            cand = (self.key[r] != NO_KEY) \
                & (self.key[r] > self.last[r, None]) \
                & (self.ent[r] < gate[go, None])
            srt = torch.sort(torch.where(cand, self.key[r], NO_KEY),
                             1).values
            g = srt.shape[1]
            q = torch.full((r.numel(), self.gq), NO_KEY, dtype=torch.int64,
                           device=r.device)
            q[:, :min(g, self.gq)] = srt[:, :self.gq]
            self.q[r] = q
            off = srt[:, self.gq:]
            fell = off != NO_KEY
            self.fell_neg[r] = (fell & ((off & KEY_NEG) != 0)).any(1)
            self.fell_pos[r] = (fell & ((off & KEY_NEG) == 0)).any(1)


def _onehot2_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o, d,
                   tmin, tmax, visibility, shadow_any_hit, has_instances,
                   queue, gqueue, time=None, has_motion=False):
    n = o.shape[0]
    sc, c, gmax = sc_bounds.shape[0], cbounds.shape[0], int(gmax)
    ct = int(cluster_tris)
    time = ci.lane_time(time, n, has_motion, o.device)
    o, d, tmin, tmax, vis, live, *tp = tw.pad_lanes(o, d, tmin, tmax,
                                                    visibility, time)
    time = tp[0] if tp else None
    dev, lanes_n = o.device, o.shape[0]
    lane = torch.arange(lanes_n, device=dev)
    warp = lane // TILE
    nw = lanes_n // TILE
    inv = isect.safe_inv(d)
    sc_entry = ci.entry_table(sc_bounds[:, :6], o, d, tmin, tmax)
    sc_entry[:, ~live] = ci.INF
    cstart = sc_bounds[:, 6].to(torch.long)
    gcount = torch.clamp(sc_bounds[:, 7].to(torch.long), max=gmax)
    gids = torch.arange(gmax, device=dev)
    hit = tw.new_hit(tmax)
    ws = ci._lane_ws(o, d)
    sc_ret = torch.zeros((sc, nw), dtype=torch.bool, device=dev)
    running = torch.ones(nw, dtype=torch.bool, device=dev)
    cnt = torch.zeros((lanes_n, len(COUNTS)), dtype=torch.long, device=dev)
    warp_steps = torch.zeros(lanes_n, dtype=torch.long, device=dev)
    queues = tw.LaneQueues(lanes_n, queue, live) if queue else None
    last_m = torch.zeros((lanes_n, 12), dtype=torch.int32, device=dev)
    have_m = torch.zeros(lanes_n, dtype=torch.bool, device=dev)
    scratch = torch.zeros(lanes_n, dtype=torch.long, device=dev)
    pbase = ci.prim_col(ct, time is not None)
    for _ in range(sc):
        gate = tw.lane_gate(hit, shadow_any_hit)
        on = running[warp]
        if queues is None:
            me, ms = tw.table_pick(sc_entry, (sc_entry < gate[None])
                                   & ~sc_ret[:, warp] & on[None])
        else:
            he, hc = queues.head(on, sc_entry, sc_ret, warp, gate,
                                 cnt[:, 7], scratch)
            me, ms = tw.warp_min(he, hc, tw.NO_ID)
        running = running & (me < ci.INF)
        if not bool(running.any()):
            break
        on = running[warp]
        cnt[:, 0] += on
        s_lane = ms[warp].clamp(max=sc - 1)
        walk = on & (sc_entry[s_lane, lane] < gate)
        cnt[:, 1] += walk
        idx = walk.nonzero()[:, 0]
        rows_before = cnt[:, 4].clone()
        if idx.numel():
            s = s_lane[idx]
            need = torch.minimum(gate, tmax)[idx]
            b = cbounds[(cstart[s][None] + gids[:, None]).clamp(max=c - 1)]
            e = k5._slab(b, o[idx], inv[idx], tmin[idx], need).T
            key, ent = _keys(e, gids)
            key = torch.where((gids[None] < gcount[s][:, None])
                              & (e < ci.INF), key, NO_KEY)
            gw = _GroupWalk(idx, key, ent, gqueue if queues else 0)
            gc = gcount[s]
            if queues is None:   # an empty group: the rescan loop never runs
                gw.done |= gc == 0
            step = 0
            while not bool(gw.done.all()):
                if queues is None:
                    g = tw.lane_gate(hit, shadow_any_hit)
                    r, best = gw.scan_step(g[idx], step, gc, cnt)
                else:
                    r, best = gw.queue_step(
                        lambda rr: tw.lane_gate(hit, shadow_any_hit)[idx[rr]],
                        gc, cnt)
                step += 1
                # each step visits a new cluster: a lane of a sound walk
                # reads at most its group's gcount rows
                assert step <= gmax + 1, "a group walk outran its clusters"
                if r.numel() == 0:
                    continue
                gw.last[r] = best
                li = idx[r]
                cid = cstart[s[r]] + (best & ((1 << KEY_ID_BITS) - 1))
                rows_ = ctable[cid]
                cnt[li, 4] += 1
                pid = rows_[:, pbase:pbase + ct]
                tvis = rows_[:, pbase + 2 * ct:pbase + 3 * ct].to(torch.int32)
                tested = ((pid >= 0.0)
                          & ((tvis & vis[li, None]) != 0)).any(1)
                cnt[li, 5] += tested
                if has_instances:
                    if queues is None:
                        cnt[li, 6] += 1
                    else:
                        m = rows_[:, :12].contiguous().view(torch.int32)
                        xf = tested & ~(have_m[li] & (m == last_m[li]).all(1))
                        cnt[li, 6] += xf
                        last_m[li[xf]] = m[xf]
                        have_m[li[xf]] = True
                test = torch.zeros(lanes_n, dtype=torch.bool, device=dev)
                test[li] = True
                cid_l = torch.zeros(lanes_n, dtype=torch.long, device=dev)
                cid_l[li] = cid
                tw.row_test(ctable, ct, cid_l, test, ws, tmin, vis, hit,
                            *((o, d) if has_instances else (None, None)),
                            time=time)
                if shadow_any_hit:
                    gw.done[r[hit["prim"][li] >= 0]] = True
        steps = (cnt[:, 4] - rows_before).view(-1, TILE).amax(1)
        warp_steps += steps[warp]
        wi = running.nonzero()[:, 0]
        sc_ret[ms[wi], wi] = True
    if queues is None:   # the first design scans its table for every pick
        cnt[:, 7] = cnt[:, 0] + 1
    out = {k: x[:n] for k, x in hit.items()}
    return out, cnt[:n].to(torch.int32), warp_steps[:n].to(torch.int32)


def onehot2_scan_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o, d,
                       tmin, tmax, visibility, shadow_any_hit=False,
                       has_instances=False, time=None, has_motion=False):
    """K6's first design as plain torch: lanes in warps of 32; the warp
    picks the lexicographic minimum (entry, supercluster) over its lanes'
    unretired entries below their gates ((SC, 32) table scan); each lane
    whose own entry is below its gate walks the group alone: with its
    segment capped by its gate at group entry it rescans the group's boxes
    for its smallest packed key above the last one whose truncated entry
    is below its gate (at most gcount visits), reads that row, transforms
    its ray by the row's w2o and tests the triangles, with has_motion at
    its time (an any-hit lane stops at its hit); then the supercluster is
    retired for the warp. Returns
    (hit dict, (N, 8) int32 counts as COUNTS: box tests and passes are the
    rescans', transforms one per row read, supercluster passes the picks'
    table scans; (N,) int32 the warp's inner steps: the sum over the
    groups it entered of the most rows a lane of it read)."""
    return _onehot2_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o,
                          d, tmin, tmax, visibility, shadow_any_hit,
                          has_instances, None, None, time, has_motion)


def onehot2_queue_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o,
                        d, tmin, tmax, visibility, shadow_any_hit=False,
                        has_instances=False, queue=SC_QUEUE, gqueue=G_QUEUE,
                        time=None, has_motion=False):
    """K6's kernel as plain torch: the same walk with the supercluster
    pick taken from per-lane queues of `queue` pairs
    (tile_walk.LaneQueues, at most SC entries a warp) and each group walk
    from one box pass into a queue of `gqueue` packed keys, culled heads
    dropped, another pass above the last key when it runs dry while a key
    fell off; a transform only at a row the lane tests (a triangle not
    skipped) whose w2o bits differ from the last it used; with has_motion
    the triangles are tested at the lane's time. Returns (hit
    dict, (N, 8) int32 counts: those of
    intersect_clusters2_onehot(counts=True), (N,) int32 the warp's inner
    steps)."""
    return _onehot2_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o,
                          d, tmin, tmax, visibility, shadow_any_hit,
                          has_instances, int(queue), int(gqueue), time,
                          has_motion)


def grid_tables2(sc, g, ct, rng, device="cpu", pitch=100.0, size=80.0,
                 shared_box=False):
    """A two-level table of sc superclusters of g clusters of ct random
    triangles, with instance rows: supercluster s sits at cell s of a
    cubic grid of pitch `pitch` and is one instance (w2o a translation by
    minus its cell corner); its clusters hold their triangles, in object
    space, in cubes of a sub-grid of the cell's `size` (shared_box: all in
    one cube of side `size`, so a group's boxes are equal and its entries
    tie). Boundary-free; visibility 255. Returns (sc_bounds, cbounds,
    ctable) on `device`."""
    side = int(np.ceil(sc ** (1.0 / 3.0)))
    grid = lambda k: np.stack(np.meshgrid(*[np.arange(k)] * 3,
                                          indexing="ij"), -1).reshape(-1, 3)
    cells = (grid(side)[:sc] * pitch).astype(np.float32)
    gs = int(np.ceil(g ** (1.0 / 3.0)))
    sub = np.zeros((g, 3)) if shared_box else grid(gs)[:g] * (size / gs)
    csize = size if shared_box else 0.8 * size / gs
    clusters = []
    for s in range(sc):
        w2o = np.eye(3, 4, dtype=np.float32)
        w2o[:, 3] = -cells[s]
        for k in range(g):
            lo = sub[k].astype(np.float32)
            verts = (lo + rng.uniform(0.0, csize, (ct, 3, 3))).astype(
                np.float32)
            cid = s * g + k
            clusters.append({
                "verts": verts, "prim": np.arange(cid * ct, (cid + 1) * ct),
                "obj": np.full(ct, s, np.int32),
                "vis": np.full(ct, 255, np.int32), "w2o": w2o,
                "lo": cells[s] + lo, "hi": cells[s] + lo + np.float32(csize)})
    cb, ctab, _ = ci.pack_cluster_table(clusters)
    scb = np.zeros((sc, 8), np.float32)
    for s in range(sc):
        scb[s, :3] = cb[s * g:(s + 1) * g, :3].min(0)
        scb[s, 3:6] = cb[s * g:(s + 1) * g, 3:].max(0)
        scb[s, 6:] = (s * g, g)
    return tuple(torch.tensor(x, device=device) for x in (scb, cb, ctab))
