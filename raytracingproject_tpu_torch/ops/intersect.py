"""Watertight ray/triangle test and the dense sweeps (JAX counterpart:
raytracingproject_tpu/ops/intersect.py `watertight_setup` :48,
`watertight_test` :108, `_wt_block` :289, `_safe_inv` :195,
`_pack_tri_blocks` :211, `intersect_brute` :298, `shadow_blocked_brute`
:544, `intersect_brute_occlusion` :588; `intersect_brute_mt` follows
ops/pallas_intersect.py `_mt_block` :37 and `intersect_brute_pallas` :112).

These torch functions are the spec the CUDA kernels (csrc/*.cu) follow
line by line: the Woop/Benthin/Wald shear basis folded into three dense
per-lane rows, edge functions with a few-ulp tolerance band so shared
edges can never leak, and the same operation order everywhere, so the
plain walks and the kernels agree to the ulp when FMA contraction is off.

The dense sweeps test every ray against every triangle, in blocks of 8
triangles as the JAX package does: `intersect_brute` (closest hit),
`shadow_blocked_brute` (any hit), `intersect_brute_occlusion` (the volume
NEE's dual form: two masked minima and an any hit) and
`intersect_brute_mt` (the Moeller-Trumbore arithmetic of the TPU kernel).
They are the plain versions of csrc/dense_sweep.cu (ops/dense_sweep.py).
Deform motion (per-ray time) is not ported.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.utils.math import RAY_TMAX

# sign-test tolerance, in ulps of the edge-function product magnitudes
WT_EPS = 4.0 * 2.0 ** -23


def watertight_setup_c(ox, oy, oz, dx, dy, dz):
    """Per-ray shear basis on ray components. Returns a dict of per-lane
    tensors: rows rx/ry/rz (3-tuples), offsets rxo/ryo/rzo, degenerate."""
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    zmax = (az >= ax) & (az >= ay)
    ymax = ~zmax & (ay >= ax)
    kz = torch.where(zmax, 2, torch.where(ymax, 1, 0))
    d_kz = torch.where(zmax, dz, torch.where(ymax, dy, dx))
    neg = d_kz < 0.0
    kx = torch.where(neg, (kz + 2) % 3, (kz + 1) % 3)
    ky = torch.where(neg, (kz + 1) % 3, (kz + 2) % 3)

    def onehot(k):
        return tuple((k == i).to(dx.dtype) for i in range(3))

    ex, ey, ez = onehot(kx), onehot(ky), onehot(kz)

    def pick(e, vx, vy, vz):
        return e[0] * vx + e[1] * vy + e[2] * vz

    d_kx = pick(ex, dx, dy, dz)
    d_ky = pick(ey, dx, dy, dz)
    inv_kz = 1.0 / torch.where(d_kz == 0, 1.0, d_kz)
    sx = d_kx * inv_kz
    sy = d_ky * inv_kz
    sz = inv_kz
    rx = tuple(ex[i] - sx * ez[i] for i in range(3))
    ry = tuple(ey[i] - sy * ez[i] for i in range(3))
    rz = tuple(sz * ez[i] for i in range(3))
    return {
        "rx": rx, "ry": ry, "rz": rz,
        "rxo": pick(rx, ox, oy, oz),
        "ryo": pick(ry, ox, oy, oz),
        "rzo": pick(rz, ox, oy, oz),
        "degenerate": (ax == 0) & (ay == 0) & (az == 0),
    }


def watertight_setup(o, d):
    return watertight_setup_c(o[..., 0], o[..., 1], o[..., 2],
                              d[..., 0], d[..., 1], d[..., 2])


def watertight_test(ws, v0c, v1c, v2c, tmin, tmax):
    """Watertight test on corner component tuples (each broadcastable
    against the per-lane tensors in ws). Returns (valid, t, u, v) with
    P = (1-u-v)*v0 + u*v1 + v*v2."""
    def shear(vc):
        x = ws["rx"][0] * vc[0] + ws["rx"][1] * vc[1] \
            + ws["rx"][2] * vc[2] - ws["rxo"]
        y = ws["ry"][0] * vc[0] + ws["ry"][1] * vc[1] \
            + ws["ry"][2] * vc[2] - ws["ryo"]
        z = ws["rz"][0] * vc[0] + ws["rz"][1] * vc[1] \
            + ws["rz"][2] * vc[2] - ws["rzo"]
        return x, y, z

    ax, ay, az = shear(v0c)
    bx, by, bz = shear(v1c)
    cx, cy, cz = shear(v2c)

    def edge(px, py, qx, qy):
        p1 = px * qy
        p2 = py * qx
        return p1 - p2, WT_EPS * (p1.abs() + p2.abs())

    w_a, tol_a = edge(bx, by, cx, cy)
    w_b, tol_b = edge(cx, cy, ax, ay)
    w_c, tol_c = edge(ax, ay, bx, by)
    det = w_a + w_b + w_c
    sign_ok = ((w_a >= -tol_a) & (w_b >= -tol_b) & (w_c >= -tol_c)) \
        | ((w_a <= tol_a) & (w_b <= tol_b) & (w_c <= tol_c))
    det_ok = det.abs() > tol_a + tol_b + tol_c
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    t = (w_a * az + w_b * bz + w_c * cz) * inv
    u = torch.clamp(w_b * inv, 0.0, 1.0)
    v = torch.clamp(w_c * inv, 0.0, 1.0)
    valid = sign_ok & det_ok & (t > tmin) & (t < tmax) & ~ws["degenerate"]
    return valid, t, u, v


def wt_block(ws, v0c, e1c, e2c, tmin, tmax):
    """watertight_test on (v0, e1, e2) component triples (the cluster
    row layout); corners are rebuilt as v0 + e."""
    v1c = tuple(v0c[i] + e1c[i] for i in range(3))
    v2c = tuple(v0c[i] + e2c[i] for i in range(3))
    return watertight_test(ws, v0c, v1c, v2c, tmin, tmax)


def safe_inv(d):
    return torch.where(d.abs() > 1e-20,
                       1.0 / torch.where(d == 0, 1.0, d),
                       torch.where(d >= 0, 1e20, -1e20))


# ---------------------------------------------------------------------
# dense sweeps

TRI_BLOCK = 8
# (triangles x lanes) elements one step of a plain sweep may hold
_STEP_ELEMS = 1 << 21


def pack_tri_blocks(tri_verts, prim_object, visibility_arr, block=TRI_BLOCK):
    """Pad and reshape triangle data to blocks: (nb, v0, e1, e2, object,
    visibility), each (nb, block, ...); padding triangles are all zero
    with object -1."""
    p = tri_verts.shape[0]
    pad = (-p) % block
    pad3 = torch.zeros((pad, 3, 3), dtype=tri_verts.dtype,
                       device=tri_verts.device)
    tv = torch.cat([tri_verts, pad3])
    po = torch.cat([prim_object, torch.full(
        (pad,), -1, dtype=prim_object.dtype, device=prim_object.device)])
    nb = (p + pad) // block
    pv = None
    if visibility_arr is not None:
        pv = torch.cat([visibility_arr, torch.zeros(
            pad, dtype=visibility_arr.dtype,
            device=visibility_arr.device)]).reshape(nb, block)
    v0 = tv[:, 0].reshape(nb, block, 3)
    e1 = (tv[:, 1] - tv[:, 0]).reshape(nb, block, 3)
    e2 = (tv[:, 2] - tv[:, 0]).reshape(nb, block, 3)
    return nb, v0, e1, e2, po.reshape(nb, block), pv


def _prim_visibility(prim_object, object_visibility):
    return object_visibility[prim_object.clamp(min=0).long()]


def _blocks_per_step(nb, block, n):
    return max(1, min(nb, _STEP_ELEMS // max(block * n, 1)))


def _wt_step(ws, v0, e1, e2, tmin, tmax):
    """wt_block of G blocks against N lanes: v0/e1/e2 (G, B, 3), tmin
    (N,), tmax (N,) or a float; returns (G, B, N) tensors."""
    def comps(a):
        return tuple(a[:, :, i, None] for i in range(3))

    if torch.is_tensor(tmax):
        tmax = tmax[None, None]
    return wt_block(ws, comps(v0), comps(e1), comps(e2), tmin[None, None],
                    tmax)


def intersect_brute(tri_verts, prim_object, o, d, tmin, tmax,
                    visibility=None, object_visibility=None,
                    block=TRI_BLOCK):
    """Dense closest hit of N rays against P world-space triangles.

    tri_verts (P, 3, 3) f32, prim_object (P,) int32; o, d (N, 3); tmin,
    tmax (N,); visibility (N,) int32 with object_visibility (nobj,) int32
    masks prims by object_visibility[prim_object] & visibility. Returns
    dict t, u, v (f32) and prim, object (int32, -1 on a miss; t is
    min(tmax, RAY_TMAX) then). Blocks of `block` triangles are taken in
    order against the running best t: inside a block a tie in t goes to
    the highest index (u and v each to the largest of the tied), and a
    later block wins only with a strictly smaller t. Several blocks are
    tested at once against the best t before them, which selects the same
    winner."""
    n = o.shape[0]
    dev = o.device
    use_vis = visibility is not None and object_visibility is not None
    nb, v0b, e1b, e2b, pob, pvb = pack_tri_blocks(
        tri_verts, prim_object,
        _prim_visibility(prim_object, object_visibility) if use_vis
        else None, block)
    ws = watertight_setup(o, d)
    t0 = torch.clamp(tmax, max=RAY_TMAX)
    t_best = t0
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    kidx = torch.arange(block, dtype=torch.int32, device=dev)[None, :, None]
    step = _blocks_per_step(nb, block, n)
    ninf = float("-inf")
    for b0 in range(0, nb, step):
        sl = slice(b0, b0 + step)
        hit, t, u, v = _wt_step(ws, v0b[sl], e1b[sl], e2b[sl], tmin, t_best)
        hit = hit & (pob[sl, :, None] >= 0)
        if use_vis:
            hit = hit & ((pvb[sl, :, None] & visibility[None, None]) > 0)
        t = torch.where(hit, t, RAY_TMAX)
        tk = t.min(1).values                                  # (G, N)
        win = t == tk[:, None]
        k = torch.where(win, kidx, -1).amax(1)
        uk = torch.where(win, u, ninf).amax(1)
        vk = torch.where(win, v, ninf).amax(1)
        # the first block of the step holding the step's minimum
        tg = tk.min(0).values
        g = torch.arange(tk.shape[0], device=dev)[:, None]
        gi = torch.where(tk == tg[None], g, tk.shape[0]).amin(0)[None]
        better = tg < t_best
        t_best = torch.where(better, tg, t_best)
        prim_best = torch.where(
            better, ((b0 + gi) * block + k.gather(0, gi))[0].to(torch.int32),
            prim_best)
        u_best = torch.where(better, uk.gather(0, gi)[0], u_best)
        v_best = torch.where(better, vk.gather(0, gi)[0], v_best)
    hit_mask = (t_best < t0) & (prim_best >= 0)
    prim = torch.where(hit_mask, prim_best, -1)
    obj = torch.where(hit_mask,
                      prim_object[prim.clamp(min=0).long()].to(torch.int32),
                      -1)
    return {"t": t_best, "prim": prim, "u": u_best, "v": v_best,
            "object": obj}


def shadow_blocked_brute(tri_verts, prim_object, o, d, tmin, tmax,
                         visibility=None, object_visibility=None,
                         block=TRI_BLOCK):
    """Dense any hit inside (tmin, tmax): (N,) bool. Same masks as
    intersect_brute, no winner."""
    n = o.shape[0]
    use_vis = visibility is not None and object_visibility is not None
    nb, v0b, e1b, e2b, pob, pvb = pack_tri_blocks(
        tri_verts, prim_object,
        _prim_visibility(prim_object, object_visibility) if use_vis
        else None, block)
    ws = watertight_setup(o, d)
    blocked = torch.zeros(n, dtype=torch.bool, device=o.device)
    step = _blocks_per_step(nb, block, n)
    for b0 in range(0, nb, step):
        sl = slice(b0, b0 + step)
        hit, _t, _u, _v = _wt_step(ws, v0b[sl], e1b[sl], e2b[sl], tmin, tmax)
        hit = hit & (pob[sl, :, None] >= 0)
        if use_vis:
            hit = hit & ((pvb[sl, :, None] & visibility[None, None]) > 0)
        blocked = blocked | hit.any(1).any(0)
    return blocked


def intersect_brute_occlusion(tri_verts, prim_object, boundary_mask,
                              o, d, tmin, tmax_closest, tmax_any,
                              visibility_closest, visibility_any,
                              object_visibility, block=TRI_BLOCK):
    """The volume NEE's dense sweep, no winner: (t_boundary, t_other,
    blocked). t_boundary / t_other are RAY_TMAX-capped minima of hit t
    over boundary / other prims (boundary_mask (P,) bool) visible to
    visibility_closest inside (tmin, tmax_closest); blocked is any hit
    visible to visibility_any inside (tmin, tmax_any). Every triangle is
    tested against RAY_TMAX and windowed afterwards (t < tmax)."""
    n = o.shape[0]
    dev = o.device
    nb, v0b, e1b, e2b, pob, pvb = pack_tri_blocks(
        tri_verts, prim_object,
        _prim_visibility(prim_object, object_visibility), block)
    pad = nb * block - tri_verts.shape[0]
    bm = torch.cat([boundary_mask.to(torch.bool), torch.zeros(
        pad, dtype=torch.bool, device=dev)]).reshape(nb, block)
    ws = watertight_setup(o, d)
    t_b = torch.full((n,), RAY_TMAX, device=dev)
    t_o = torch.full((n,), RAY_TMAX, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    step = _blocks_per_step(nb, block, n)
    for b0 in range(0, nb, step):
        sl = slice(b0, b0 + step)
        geom, t, _u, _v = _wt_step(ws, v0b[sl], e1b[sl], e2b[sl], tmin,
                                   RAY_TMAX)
        geom = geom & (pob[sl, :, None] >= 0)
        pv = pvb[sl, :, None]
        blocked = blocked | (
            geom & (t < tmax_any[None, None])
            & ((pv & visibility_any[None, None]) > 0)).any(1).any(0)
        hit_c = geom & (t < tmax_closest[None, None]) \
            & ((pv & visibility_closest[None, None]) > 0)
        bmk = bm[sl, :, None]
        t_b = torch.minimum(
            t_b, torch.where(hit_c & bmk, t, RAY_TMAX).amin((0, 1)))
        t_o = torch.minimum(
            t_o, torch.where(hit_c & ~bmk, t, RAY_TMAX).amin((0, 1)))
    return t_b, t_o, blocked


MT_DET_EPS = 1e-12


def intersect_brute_mt(tri_v0, tri_e1, tri_e2, o, d, tmin, tmax):
    """Dense closest hit in Moeller-Trumbore arithmetic, the contract of
    the JAX package's TPU kernel: tri_v0/e1/e2 (nb, 8, 3) packets (padded
    with all-zero triangles), |det| > 1e-12, u, v in [0, 1], u + v <= 1,
    t > tmin; the first triangle with the smallest t wins. Returns dict
    t, prim, u, v with prim -1 and t = min(tmax, RAY_TMAX) where no hit
    lies below that."""
    p = tri_v0.shape[0] * tri_v0.shape[1]
    v0, e1, e2 = (a.reshape(p, 3) for a in (tri_v0, tri_e1, tri_e2))

    def c(a, i):
        return a[:, i, None]

    ox, oy, oz = (o[None, :, i] for i in range(3))
    dx, dy, dz = (d[None, :, i] for i in range(3))
    px = dy * c(e2, 2) - dz * c(e2, 1)
    py = dz * c(e2, 0) - dx * c(e2, 2)
    pz = dx * c(e2, 1) - dy * c(e2, 0)
    det = c(e1, 0) * px + c(e1, 1) * py + c(e1, 2) * pz
    det_ok = det.abs() > MT_DET_EPS
    inv = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tx, ty, tz = ox - c(v0, 0), oy - c(v0, 1), oz - c(v0, 2)
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * c(e1, 2) - tz * c(e1, 1)
    qy = tz * c(e1, 0) - tx * c(e1, 2)
    qz = tx * c(e1, 1) - ty * c(e1, 0)
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (c(e2, 0) * qx + c(e2, 1) * qy + c(e2, 2) * qz) * inv
    hit = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > tmin[None]) & (t < RAY_TMAX)
    tm = torch.where(hit, t, RAY_TMAX)
    t_best = tm.amin(0)
    idx = torch.arange(p, device=o.device)[:, None]
    first = torch.where(hit & (tm == t_best[None]), idx, p).amin(0)
    found = first < p
    k = first.clamp(max=p - 1)[None]
    u_best = torch.where(found, u.gather(0, k)[0], 0.0)
    v_best = torch.where(found, v.gather(0, k)[0], 0.0)
    t0 = torch.clamp(tmax, max=RAY_TMAX)
    ok = t_best < t0
    return {"t": torch.where(ok, t_best, t0),
            "prim": torch.where(ok & found, first, -1).to(torch.int32),
            "u": u_best, "v": v_best}
