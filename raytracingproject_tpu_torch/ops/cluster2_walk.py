"""K5: the two-level tile-shared cluster walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_cluster.py intersect_clusters2_pallas).

`intersect_clusters2_walk` takes the supercluster table sc_bounds (SC, 8)
and its group size gmax beside the cluster tables and has the contract of
the plain walk ops/cluster_intersect.py `intersect_clusters` over all C
clusters, which is its plain version (the second level only prunes). A
CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel csrc/cluster2_walk.cu or raises. The kernel walks a
warp of 32 rays together, one supercluster and then one cluster per step,
so prim and object may differ from the plain version's at exact-t ties
between clusters; hit masks agree, and t, u and v on every lane whose
prim and object do. Instance rows (w2o in the row) are tested in object
space. Motion rows (has_motion, ops/cluster_intersect.py) are tested at
each lane's time (time (N,) f32; zeros when None, as the JAX walks take
it): the boxes cover both shutter ends, so the visit order needs nothing
more; motion rows never carry instances, and the two together raise.
`launches` counts kernel launches. With
counts=True the counting variant runs and the call also returns (N, 6)
int32 counts per lane (CUDA tensors only): the superclusters its warp
entered, the group tables it filled, the rows its warp fetched, the rows
it tested, the w2o transforms it computed and its supercluster passes.

Two plain torch mirrors of the warp's visit order, for the tests and the
checks on the card (never a render path): `cluster2_scan_order` emulates
the earlier design (a (SC, 32) supercluster entry table scanned on every
pick; every lane transforms its ray by every row), `cluster2_queue_order`
the kernel's (per-lane queues of SC_QUEUE (entry, supercluster) pairs and
a retired bitmask, as K4's; the group level keeps its gate-capped (gmax,
32) table; a lane transforms its ray only for a row it tests whose w2o
differs from the last one it used). Both visit the same rows in the same
order, so every output and every step count is equal. Both take the
lanes' times with motion rows.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk as cw
from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.ops import tile_walk as tw

launches = 0

MAX_SUPERCLUSTERS = 512        # the JAX package's two-level cap
TILE = 32
SMEM_BYTES = 227 * 1024        # shared memory a block may have (H100)
SC_QUEUE = 4                   # K5_QUEUE of csrc/cluster2_walk.cu


def smem_per_warp(sc, gmax, w):
    """The capacity rule K5 keeps from its first design, which held a
    (SC, 32) and a (gmax, 32) entry table and a row per warp: ((SC +
    gmax) x 32 + W) x 4 bytes within a block's shared memory. The queue
    design needs less (the supercluster table once per block, then per
    warp the group table and a row), so every table the rule admits
    launches, and the dispatch refuses what it refused before."""
    return ((sc + gmax) * TILE + w) * 4


def intersect_clusters2_walk(sc_bounds, cbounds, ctable, cluster_tris, gmax,
                             o, d, tmin, tmax, visibility,
                             shadow_any_hit=False, has_instances=False,
                             has_motion=False, time=None, counts=False):
    """Closest hit (or any hit) over the two-level cluster tables;
    returns dict t, u, v (f32) and prim, object (int32), (N,) each; with
    counts=True (hit dict, (N, 6) int32 counts as the module states)."""
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
    kernels.require(int(gmax) > 0, "gmax must be positive")
    kernels.unsupported(
        smem_per_warp(sc_bounds.shape[0], int(gmax), ctable.shape[1])
        <= SMEM_BYTES,
        f"SC {sc_bounds.shape[0]} + gmax {gmax} entry tables do not fit one "
        "warp's shared memory")
    cnt = torch.empty((o.shape[0], 6), dtype=torch.int32,
                      device=o.device) if counts else None
    out = launch_two_level("rt_cluster2_walk", sc_bounds, cbounds, ctable,
                           cluster_tris, gmax, o, d, tmin, tmax, visibility,
                           shadow_any_hit, has_instances,
                           ci.lane_time(time, o.shape[0], has_motion,
                                        o.device),
                           (cnt.data_ptr() if counts else None,))
    launches += 1
    return (out, cnt) if counts else out


def launch_two_level(entry, sc_bounds, cbounds, ctable, cluster_tris, gmax,
                     o, d, tmin, tmax, visibility, shadow_any_hit,
                     has_instances, time, extra=()):
    """Check the arguments the two-level kernels share (K5's
    rt_cluster2_walk, K6's rt_onehot2_walk: one argument list, K5's with
    the counts pointer in `extra`; with time, motion rows and the lanes'
    times), allocate the outputs and launch C entry point `entry`;
    returns the hit dict."""
    n, sc, c, w = o.shape[0], sc_bounds.shape[0], cbounds.shape[0], \
        ctable.shape[1]
    kernels.unsupported(
        sc <= MAX_SUPERCLUSTERS,
        f"{sc} superclusters: the kernel takes at most {MAX_SUPERCLUSTERS}")
    req = kernels.require
    lanes = (("sc_bounds", sc_bounds), ("cbounds", cbounds),
             ("ctable", ctable), ("o", o), ("d", d), ("tmin", tmin),
             ("tmax", tmax), ("visibility", visibility))
    if time is not None:
        lanes += (("time", time),)
    for name, x in lanes:
        req(x.device.type == "cuda", f"{name} must be a CUDA tensor")
        req(x.is_contiguous(), f"{name} must be contiguous")
        req(x.dtype == (torch.int32 if name == "visibility"
                        else torch.float32), f"{name}: wrong dtype {x.dtype}")
    req(sc > 0, "the walk needs at least one supercluster")
    req(sc_bounds.shape == (sc, 8), "sc_bounds must be (SC, 8)")
    req(c > 0 and cbounds.shape == (c, 6), "cbounds must be (C, 6)")
    req(ctable.shape[0] == c
        and w == ci.row_width(cluster_tris, time is not None),
        "ctable must be (C, row_width(cluster_tris, motion))")
    req(o.shape == (n, 3) and d.shape == (n, 3), "o, d must be (N, 3)")
    for x in (tmin, tmax, visibility) + ((time,) if time is not None
                                         else ()):
        req(x.shape == (n,), "tmin, tmax, visibility, time must be (N,)")
    dev = o.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    obj = torch.empty(n, dtype=torch.int32, device=dev)
    rc = getattr(kernels.load(), entry)(
        sc_bounds.data_ptr(), cbounds.data_ptr(), ctable.data_ptr(), sc, c,
        w, int(cluster_tris), int(gmax), o.data_ptr(), d.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), visibility.data_ptr(), n,
        int(bool(shadow_any_hit)), int(bool(has_instances)),
        int(time is not None), time.data_ptr() if time is not None else None,
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        obj.data_ptr(), *extra, kernels.current_stream())
    kernels.check_rc(entry, rc)
    return {"t": t, "prim": prim, "u": u, "v": v, "object": obj}


# ---- the plain mirrors of the warp's visit order ----

_OUTER, _INNER, _DONE = 0, 1, 2


def _slab(b, o, inv, tmin, tmax):
    """Each lane's entry into its own boxes b (..., N, 6): entry_table's
    operations (csrc/watertight.cuh slab_entry) on per-lane boxes."""
    tn = torch.full(b.shape[:-1], -ci.INF, device=o.device)
    tf = torch.full(b.shape[:-1], ci.INF, device=o.device)
    for ax in range(3):
        t0 = (b[..., ax] - o[:, ax]) * inv[:, ax]
        t1 = (b[..., 3 + ax] - o[:, ax]) * inv[:, ax]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    ok = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
    return torch.where(ok, torch.maximum(tn, tmin), ci.INF)


def _cluster2_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o, d,
                    tmin, tmax, visibility, shadow_any_hit, has_instances,
                    queue, time=None, has_motion=False):
    n = o.shape[0]
    sc, c, gmax = sc_bounds.shape[0], cbounds.shape[0], int(gmax)
    time = ci.lane_time(time, n, has_motion, o.device)
    o, d, tmin, tmax, vis, live, *tp = tw.pad_lanes(o, d, tmin, tmax,
                                                    visibility, time)
    time = tp[0] if tp else None
    dev, lanes_n = o.device, o.shape[0]
    lane = torch.arange(lanes_n, device=dev)
    warp = lane // tw.TILE
    nw = lanes_n // tw.TILE
    inv = isect.safe_inv(d)
    sc_entry = ci.entry_table(sc_bounds[:, :6], o, d, tmin, tmax)
    sc_entry[:, ~live] = ci.INF
    cstart = sc_bounds[:, 6].to(torch.long)
    gcount = sc_bounds[:, 7].to(torch.long)
    gids = torch.arange(gmax, device=dev)
    centry = torch.full((gmax, lanes_n), ci.INF, device=dev)
    hit = tw.new_hit(tmax)
    ws = ci._lane_ws(o, d)
    mode = torch.full((nw,), _OUTER, dtype=torch.long, device=dev)
    cur = torch.zeros(nw, dtype=torch.long, device=dev)
    sc_ret = torch.zeros((sc, nw), dtype=torch.bool, device=dev)
    # superclusters entered, fills, rows fetched, rows tested, transforms,
    # supercluster passes
    cnt = torch.zeros((lanes_n, 6), dtype=torch.long, device=dev)
    queues = tw.LaneQueues(lanes_n, queue, live) if queue else None
    last_m = torch.zeros((lanes_n, 12), dtype=torch.int32, device=dev)
    have_m = torch.zeros(lanes_n, dtype=torch.bool, device=dev)
    scratch = torch.zeros(lanes_n, dtype=torch.long, device=dev)
    while bool((mode != _DONE).any()):
        gate = tw.lane_gate(hit, shadow_any_hit)
        inner = mode == _INNER
        if bool(inner.any()):
            on = inner[warp]
            me, mg = tw.table_pick(centry, (centry < gate[None]) & on[None])
            found = inner & (me < ci.INF)
            on = found[warp]
            g = mg[warp].clamp(max=gmax - 1)
            cid = (cstart[cur[warp]] + g).clamp(max=c - 1)
            test = on & (centry[g, lane] < gate)
            if has_instances:
                if queues is None:
                    cnt[:, 4] += on
                else:
                    m = ctable[cid, :12].contiguous().view(torch.int32)
                    xf = test & ~(have_m & (m == last_m).all(1))
                    cnt[:, 4] += xf
                    last_m[xf] = m[xf]
                    have_m |= xf
            cnt[:, 3] += test
            cnt[:, 2] += on
            tw.row_test(ctable, cluster_tris, cid, test, ws, tmin, vis, hit,
                        *((o, d) if has_instances else (None, None)),
                        time=time)
            centry[g[on], on.nonzero()[:, 0]] = ci.INF
            ended = (inner & ~found).nonzero()[:, 0]
            sc_ret[cur[ended], ended] = True
            mode[ended] = _OUTER
        outer = mode == _OUTER
        if queues is not None:   # the kernel's loop takes SC entries at most
            capped = outer & (cnt[::tw.TILE, 0] >= sc)
            mode[capped] = _DONE
            outer = outer & ~capped
        if not bool(outer.any()):
            continue
        gate = tw.lane_gate(hit, shadow_any_hit)
        on = outer[warp]
        if queues is None:
            me, ms = tw.table_pick(sc_entry, (sc_entry < gate[None])
                                   & ~sc_ret[:, warp] & on[None])
        else:
            he, hc = queues.head(on, sc_entry, sc_ret, warp, gate,
                                 cnt[:, 5], scratch)
            me, ms = tw.warp_min(he, hc, tw.NO_ID)
        found = outer & (me < ci.INF)
        mode[outer & ~found] = _DONE
        if not bool(found.any()):
            continue
        wi = found.nonzero()[:, 0]
        cur[wi] = ms[wi]
        mode[wi] = _INNER
        on = found[warp]
        cnt[:, 0] += on
        cnt[:, 1] += on
        # the group's entry table, each lane's boxes capped by its gate
        need = torch.minimum(gate, tmax)
        idx = lane[on]
        s = cur[warp[idx]]
        b = cbounds[(cstart[s][None] + gids[:, None]).clamp(max=c - 1)]
        e = _slab(b, o[idx], inv[idx], tmin[idx], need[idx])
        keep = (gids[:, None] < gcount[s][None]) & live[idx][None]
        centry[:, idx] = torch.where(keep, e, ci.INF)
    out = {k: x[:n] for k, x in hit.items()}
    cnt = cnt[:n].to(torch.int32)
    return out, (cnt if queue else cnt[:, :5])


def cluster2_scan_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o, d,
                        tmin, tmax, visibility, shadow_any_hit=False,
                        has_instances=False, time=None, has_motion=False):
    """K5's earlier design as plain torch: lanes in warps of 32; the warp
    picks the lexicographic minimum (entry, supercluster) over its lanes'
    unretired entries below their gates, fills the group's (gmax, 32)
    entry table (each lane's boxes capped by its gate), walks the group
    one cluster per step as K4 does (with instance rows every lane of the
    warp transforms its ray by each row; with has_motion every lane tests
    a row's triangles at its time), then retires the supercluster.
    Returns (hit dict, (N, 5) int32: superclusters entered by the lane's
    warp, group tables filled, rows its warp fetched, rows the lane
    tested, w2o transforms it computed)."""
    return _cluster2_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o,
                           d, tmin, tmax, visibility, shadow_any_hit,
                           has_instances, None, time, has_motion)


def cluster2_queue_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o,
                         d, tmin, tmax, visibility, shadow_any_hit=False,
                         has_instances=False, queue=SC_QUEUE, time=None,
                         has_motion=False):
    """K5's kernel as plain torch: the same walk with the supercluster
    pick taken from per-lane queues of `queue` pairs
    (tile_walk.LaneQueues) and at most SC entries a warp; a lane
    transforms its ray only for a row it tests whose w2o bits differ from
    the last it used; with has_motion a lane tests a row's triangles at
    its time. Returns (hit dict, (N, 6) int32 counts: those of
    intersect_clusters2_walk(counts=True))."""
    return _cluster2_order(sc_bounds, cbounds, ctable, cluster_tris, gmax, o,
                           d, tmin, tmax, visibility, shadow_any_hit,
                           has_instances, int(queue), time, has_motion)
