"""Cluster tables and the plain cluster walks (JAX counterpart:
raytracingproject_tpu/ops/cluster_intersect.py; `occlusion_clusters`
has the contract of ops/pallas_cluster.py `occlusion_clusters_pallas`).

The BVH is cut into <= 512 clusters of <= cluster_tris triangles; each
cluster is one row of `cluster_table`:
  [w2o(12), pad(1)] [v0, e1, e2 per tri (9 each)] [prim id per tri]
  [object id per tri] [visibility per tri]
padded with prim id -1.

`intersect_clusters`, `intersect_clusters_dual` and `occlusion_clusters`
are plain torch: every lane walks its clusters front to back through a
(C, N) entry-distance table. They are what the CPU runs and what the CUDA
kernels (ops/cluster_walk.py K2, ops/tile_walk.py K4, ops/cluster2_walk.py
K5, ops/occlusion_walk.py K3, ops/dual_walk.py K7) are held against.

Instancing: an instanced scene packs every instance's BLAS clusters with
world-space bounds and the instance's world->object transform in the
row's w2o columns; with has_instances the walk transforms each lane's
ray by the visited row's w2o (t is preserved: the direction is not
renormalised) before the watertight test. Motion rows (a per-triangle
shutter delta block) are not in the port and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.utils.math import RAY_TMAX

INF = 3e38
META_COLS = 13
# lanes per walk chunk: bounds the (C, chunk) entry table
CHUNK = 65536


def row_width(cluster_tris):
    return META_COLS + cluster_tris * 12


def pack_cluster_table(clusters_np):
    """Host-side packing. clusters_np: list of dicts with keys verts
    (ct_i, 3, 3) [object space], prim (ct_i,), obj (ct_i,), vis (ct_i,),
    lo (3,), hi (3,) and optionally w2o (3, 4) (None or absent: identity).
    Returns (cluster_bounds (C, 6) f32, cluster_table (C, W) f32,
    cluster_tris)."""
    if any(cl.get("verts_t1") is not None for cl in clusters_np):
        raise NotImplementedError("motion cluster rows are not ported")
    c = len(clusters_np)
    ct = max(max((len(cl["prim"]) for cl in clusters_np), default=1), 1)
    table = np.zeros((c, row_width(ct)), np.float32)
    bounds = np.zeros((c, 6), np.float32)
    for i, cl in enumerate(clusters_np):
        bounds[i, :3] = cl["lo"]
        bounds[i, 3:] = cl["hi"]
        if cl.get("w2o") is not None:
            table[i, 0:12] = np.asarray(cl["w2o"], np.float32).reshape(12)
        else:
            table[i, 0:12] = np.eye(3, 4, dtype=np.float32).reshape(12)
        k = len(cl["prim"])
        v = np.asarray(cl["verts"], np.float32)
        tri = np.concatenate(
            [v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=1)
        table[i, META_COLS:META_COLS + 9 * k] = tri.reshape(-1)
        base = META_COLS + 9 * ct
        table[i, base:base + ct] = -1.0
        table[i, base:base + k] = np.asarray(cl["prim"], np.float32)
        base2 = base + ct
        table[i, base2:base2 + k] = np.asarray(cl["obj"], np.float32)
        base3 = base2 + ct
        table[i, base3:base3 + k] = np.asarray(cl["vis"], np.float32)
        assert np.all(np.abs(cl["prim"]) < (1 << 24))
    assert np.isfinite(table).all()
    return bounds, table, ct


def entry_table(cbounds, o, d, tmin, tmax):
    """(C, N) entry distance of each lane into each cluster box; INF when
    the segment [tmin, tmax] misses the box."""
    inv = isect.safe_inv(d)
    c, n = cbounds.shape[0], o.shape[0]
    tn = torch.full((c, n), -INF, device=o.device)
    tf = torch.full((c, n), INF, device=o.device)
    for ax in range(3):
        t0 = (cbounds[:, ax, None] - o[None, :, ax]) * inv[None, :, ax]
        t1 = (cbounds[:, 3 + ax, None] - o[None, :, ax]) * inv[None, :, ax]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    ok = (tn <= tf) & (tf >= tmin[None]) & (tn <= tmax[None])
    return torch.where(ok, torch.maximum(tn, tmin[None]), INF)


def _row_tris(rows, ct):
    """(N, W) cluster rows -> v0/e1/e2 component tuples of (N, ct)."""
    tri = rows[:, META_COLS:META_COLS + 9 * ct].reshape(-1, ct, 9)
    return (tuple(tri[..., j] for j in range(3)),
            tuple(tri[..., 3 + j] for j in range(3)),
            tuple(tri[..., 6 + j] for j in range(3)))


def _lane_ws(o, d):
    """Per-lane shear basis shaped (N, 1) to broadcast over tris."""
    ws = isect.watertight_setup(o, d)
    return {k: (tuple(x[:, None] for x in v) if isinstance(v, tuple)
                else v[:, None]) for k, v in ws.items()}


def _row_w2o_ray(rows, o, d):
    """Each lane's ray in the object space of its row: the w2o columns
    (3x4, row-major) applied as m[0]*ox + m[1]*oy + m[2]*oz + m[3], the
    operation order of the JAX package's walks and of csrc/cluster2_walk.cu
    (so both round alike)."""
    m = rows[:, 0:12]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    oo = torch.stack([m[:, 4 * r] * ox + m[:, 4 * r + 1] * oy
                      + m[:, 4 * r + 2] * oz + m[:, 4 * r + 3]
                      for r in range(3)], -1)
    dd = torch.stack([m[:, 4 * r] * dx + m[:, 4 * r + 1] * dy
                      + m[:, 4 * r + 2] * dz for r in range(3)], -1)
    return oo, dd


def _chunked(fn, n, args, lane_args):
    """Run fn over lane chunks of CHUNK; lane_args index into args."""
    if n <= CHUNK:
        return fn(*args)
    outs = []
    for s in range(0, n, CHUNK):
        a = [x[s:s + CHUNK] if i in lane_args else x
             for i, x in enumerate(args)]
        outs.append(fn(*a))
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return tuple(torch.cat([o[i] for o in outs])
                 for i in range(len(outs[0])))


def intersect_clusters(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                       visibility, shadow_any_hit=False, has_instances=False):
    """Closest hit (or any hit) over the cluster tables.

    o, d (N, 3) f32; tmin, tmax (N,) f32; visibility (N,) int. Returns
    dict t, u, v (N,) f32 and prim, object (N,) int32 (-1 on a miss; t
    is min(tmax, RAY_TMAX) on a miss). Each lane visits its clusters in
    entry order (ties: highest cluster id first, as the JAX walk does)
    and retires every cluster whose entry is behind the best hit. With
    has_instances each row's triangles are tested against the lane's ray
    transformed by that row's w2o."""
    return _chunked(
        lambda *a: _intersect_chunk(*a, shadow_any_hit=shadow_any_hit,
                                    has_instances=has_instances),
        o.shape[0], (cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                     visibility), {3, 4, 5, 6, 7})


def _intersect_chunk(cbounds, ctable, ct, o, d, tmin, tmax, visibility,
                     shadow_any_hit=False, has_instances=False):
    n, c = o.shape[0], cbounds.shape[0]
    dev = o.device
    entry = entry_table(cbounds, o, d, tmin, tmax)
    cids = torch.arange(c, device=dev)[:, None]
    lanes = torch.arange(n, device=dev)
    bt = torch.clamp(tmax, max=RAY_TMAX)
    bp = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    bo = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ws = _lane_ws(o, d)
    vis = visibility.to(torch.int32)[:, None]
    pbase = META_COLS + 9 * ct
    obase, vbase = pbase + ct, pbase + 2 * ct
    for _ in range(c):
        e_min = entry.min(0).values
        active = e_min < torch.clamp(bt, max=INF)
        if not bool(active.any()):
            break
        cid = torch.where(entry == e_min[None], cids, -1).max(0).values
        rows = ctable[cid.clamp(min=0)]
        if has_instances:
            ws = _lane_ws(*_row_w2o_ray(rows, o, d))
        v0c, e1c, e2c = _row_tris(rows, ct)
        valid, t, u, v = isect.wt_block(ws, v0c, e1c, e2c, tmin[:, None],
                                        bt[:, None])
        pid = rows[:, pbase:pbase + ct]
        tri_vis = rows[:, vbase:vbase + ct].to(torch.int32)
        hit = valid & active[:, None] & (pid >= 0.0) \
            & ((tri_vis & vis) > 0)
        # sequential strict-< updates over the cluster's tris == the
        # first minimum of the masked t (torch.min returns the first)
        tk, k = torch.where(hit, t, float("inf")).min(1)
        got = hit.any(1)
        bt = torch.where(got, tk, bt)
        bp = torch.where(got, pid[lanes, k].to(torch.int32), bp)
        bu = torch.where(got, u[lanes, k], bu)
        bv = torch.where(got, v[lanes, k], bv)
        bo = torch.where(got, rows[lanes, obase + k].to(torch.int32), bo)
        processed = (cids == cid[None]) & active[None]
        entry = torch.where(processed | (entry >= bt[None]), INF, entry)
        if shadow_any_hit:
            entry = torch.where((bp >= 0)[None], INF, entry)
    return {"t": bt, "prim": bp, "u": bu, "v": bv, "object": bo}


def intersect_clusters_dual(cbounds, ctable, cluster_tris, o_c, d_c, tmin_c,
                            tmax_c, vis_c, o_a, d_a, tmin_a, tmax_a, vis_a):
    """The union walk's contract (JAX counterpart: ops/pallas_onehot.py
    intersect_clusters_onehot_dual), computed as the two single walks it
    stands for: per lane the closest hit of ray (o_c, d_c) inside
    (tmin_c, tmax_c) under vis_c, and whether anything visible under
    vis_a blocks ray (o_a, d_a) inside (tmin_a, tmax_a). Returns (hit
    dict t, prim, u, v, object, blocked (N,) bool).

    An empty window (tmax < tmin) disables that ray of the lane: the any
    ray is then never blocked, the closest ray misses. A miss returns
    t = min(tmax_c, RAY_TMAX) (so a disabled closest ray returns its own
    negative tmax_c) and prim = object = -1."""
    hit = intersect_clusters(cbounds, ctable, cluster_tris, o_c, d_c,
                             tmin_c, tmax_c, vis_c)
    shadow = intersect_clusters(cbounds, ctable, cluster_tris, o_a, d_a,
                                tmin_a, tmax_a, vis_a, shadow_any_hit=True)
    return hit, shadow["prim"] >= 0


def occlusion_clusters(cbounds, ctable, cboundary, cluster_tris, o, d,
                       tmin, tmax_closest, tmax_any, vis_closest, vis_any):
    """Dual-reduction occlusion sweep: (t_boundary, t_other, blocked).

    t_boundary / t_other: RAY_TMAX-capped minima of hit t over
    camera-visible (vis_closest) boundary / other prims inside
    [tmin, tmax_closest]; blocked: any hit under vis_any inside
    [tmin, tmax_any]. cboundary (C, ct) 0/1 flags the boundary slots.
    The reductions are order free, so a lane may visit its clusters in
    any order; it skips a cluster whose entry is behind every window it
    can still tighten (the JAX kernel's gate)."""
    return _chunked(
        lambda *a: _occlusion_chunk(*a, vis_closest=vis_closest,
                                    vis_any=vis_any),
        o.shape[0], (cbounds, ctable, cboundary, cluster_tris, o, d, tmin,
                     tmax_closest, tmax_any), {4, 5, 6, 7, 8})


def occlusion_gate(t_b, t_o, blocked, tmaxc, tmaxa):
    """Largest t that can still matter per lane."""
    g = torch.maximum(torch.minimum(t_b, tmaxc), torch.minimum(t_o, tmaxc))
    return torch.where(blocked, g, torch.maximum(g, tmaxa))


def _occlusion_chunk(cbounds, ctable, cboundary, ct, o, d, tmin, tmaxc,
                     tmaxa, vis_closest, vis_any):
    n, c = o.shape[0], cbounds.shape[0]
    dev = o.device
    entry = entry_table(cbounds, o, d, tmin, torch.maximum(tmaxc, tmaxa))
    cids = torch.arange(c, device=dev)[:, None]
    t_b = torch.full((n,), RAY_TMAX, device=dev)
    t_o = torch.full((n,), RAY_TMAX, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    ws = _lane_ws(o, d)
    pbase = META_COLS + 9 * ct
    vbase = pbase + 2 * ct
    for _ in range(c):
        g = occlusion_gate(t_b, t_o, blocked, tmaxc, tmaxa)
        e_min, cid = torch.where(entry < g[None], entry, INF).min(0)
        active = e_min < INF
        if not bool(active.any()):
            break
        rows = ctable[cid]
        v0c, e1c, e2c = _row_tris(rows, ct)
        valid, t, _, _ = isect.wt_block(ws, v0c, e1c, e2c, tmin[:, None],
                                        RAY_TMAX)
        pid = rows[:, pbase:pbase + ct]
        tri_vis = rows[:, vbase:vbase + ct].to(torch.int32)
        is_b = cboundary[cid] > 0.0
        hit = valid & active[:, None] & (pid >= 0.0)
        hit_c = hit & (t < tmaxc[:, None]) & ((tri_vis & vis_closest) > 0)
        t_b = torch.minimum(
            t_b, torch.where(hit_c & is_b, t, float("inf")).min(1).values)
        t_o = torch.minimum(
            t_o, torch.where(hit_c & ~is_b, t, float("inf")).min(1).values)
        blocked = blocked | (hit & (t < tmaxa[:, None])
                             & ((tri_vis & vis_any) > 0)).any(1)
        entry = torch.where((cids == cid[None]) & active[None], INF, entry)
    return t_b, t_o, blocked
