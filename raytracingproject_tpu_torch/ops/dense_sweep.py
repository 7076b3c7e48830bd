"""K1: the dense sweep, every ray against every triangle (JAX
counterpart: raytracingproject_tpu/ops/pallas_intersect.py
intersect_brute_pallas, and the dense functions of ops/intersect.py that
the JAX integrator calls on scenes of at most 1,024 static prims).

Four wrappers over csrc/dense_sweep.cu, each with its plain version in
ops/intersect.py and the same signature and returns:

- `intersect_brute_sweep`   closest hit       plain: intersect_brute
- `shadow_blocked_sweep`    any hit           plain: shadow_blocked_brute
- `occlusion_sweep`         the dual form     plain: intersect_brute_occlusion
- `intersect_mt_sweep`      the TPU kernel's Moeller-Trumbore contract
                                              plain: intersect_brute_mt

The first three are what the integrator's use_brute dispatch calls; no
render calls the fourth, in either package. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Given tri_verts_t1
(the triangles at shutter close (P, 3, 3), or at the S-1 uniform steps
after shutter open (S-1, P, 3, 3)) and time ((N,) f32), the first three
run their deform modes: each ray meets the triangles where they are at
its time, as the plain versions compute it. `launches` counts kernel
launches per mode (a deform mode counts under its mode's name). With counts=True the first three run the kernel's
counting variant and also return (N, 3) int32 counts per lane: the
triangles it tested, the blocks of TRI_BLOCK triangles it kept, and the
blocks that any lane of its warp kept (CUDA tensors only).

The kernel tests a block's triangles only where `block_keep` holds: the
plain torch statement of its cull, in its operation order, which the
tests and chip_smoke.py hold against the plain watertight test and the
kernel's counts (csrc/dense_sweep.cu says why it is exact). In the deform
modes it takes the steps: the boxes span every step, and only the box
part of the cull applies. No render path calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.utils.math import RAY_TMAX

launches = {"closest": 0, "any": 0, "dual": 0, "mt": 0}

_F, _I, _B = torch.float32, torch.int32, torch.bool

# the cull's constants (csrc/dense_sweep.cu says where each comes from):
# a block's boxes grow by BOX_REL x its largest |coordinate| + BOX_ABS and
# per lane by BOX_REL x the origin's, the narrow box also by MU x its
# extent on each axis and the wide one by WIDE x that extent; the bound on
# t by T_REL of its ends; GEO_REL, C0-C3 and EPS_E set the edge-on test
BOX_REL, BOX_ABS, T_REL, MU, WIDE = 3e-5, 1e-3, 1e-5, 1e-2, 2.0
GEO_REL, C0, C1, C2, C3, EPS_E = 2e-6, 1e-5, 4e-3, 24.0, 32.0, 1e-6

_INF = float("inf")


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _corners(tv):
    """(P, 3, 3) corners v0, v0 + (tv1 - v0), v0 + (tv2 - v0)."""
    v0 = tv[:, 0]
    return torch.stack([v0, v0 + (tv[:, 1] - v0), v0 + (tv[:, 2] - v0)], 1)


def block_data(tri_verts, steps=None):
    """What the kernel stages per block of TRI_BLOCK triangles, over the
    corners v0, v0 + (tv1 - v0), v0 + (tv2 - v0) (a partial last block
    repeats its last triangle, which changes no maximum or minimum); with
    steps ((S1, P, 3, 3), the deform modes) the boxes span the corners at
    shutter open and at every step:
    (nb, 6) narrow and (nb, 6) wide padded boxes [lo, hi], (nb, 4)
    [K, B, G, M] and (nb, 8, 3) the triangles' unit normals. M is the
    block's largest |coordinate|; a lane is edge-on to a block when
    |n . d| < (K + (B + G E) E) |d| for one of its normals n, with
    E = EPS_E (M + max |o|)."""
    p = tri_verts.shape[0]
    c = _corners(tri_verts)
    c = torch.cat([c, c[-1:].expand((-p) % isect.TRI_BLOCK, 3, 3)])
    nb = c.shape[0] // isect.TRI_BLOCK
    flat = c.reshape(nb, isect.TRI_BLOCK * 3, 3)
    if steps is not None:
        cs = torch.stack([_corners(x) for x in steps], 1)   # (P, S1, 3, 3)
        cs = torch.cat([cs, cs[-1:].expand((-p) % isect.TRI_BLOCK,
                                           *cs.shape[1:])])
        flat = torch.cat([flat, cs.reshape(nb, -1, 3)], 1)
    lo, hi = flat.amin(1), flat.amax(1)
    m = torch.maximum(lo.abs().amax(1), hi.abs().amax(1))
    pad = (BOX_REL * m + BOX_ABS)[:, None]
    ext = hi - lo
    narrow = torch.cat([lo - (pad + MU * ext), hi + (pad + MU * ext)], 1)
    wide = torch.cat([lo - (pad + WIDE * ext), hi + (pad + WIDE * ext)], 1)
    e1, e2, e3 = c[:, 1] - c[:, 0], c[:, 2] - c[:, 0], c[:, 2] - c[:, 1]
    cr = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], 1)
    nl = torch.sqrt(_dot(cr, cr))
    dm = torch.maximum(torch.maximum(_dot(e1, e1), _dot(e2, e2)),
                       _dot(e3, e3))
    a2 = nl - GEO_REL * dm
    ok = a2 > 0.0
    inv = 1.0 / a2
    alpha = torch.where(ok, dm * inv, _INF).reshape(nb, -1).amax(1)
    beta = torch.where(ok, torch.sqrt(dm) * inv, _INF).reshape(nb, -1).amax(1)
    gamma = torch.where(ok, inv, _INF).reshape(nb, -1).amax(1)
    nrm = torch.where((nl > 0.0)[:, None], cr / nl[:, None], 0.0)
    geo = torch.stack([C0 + C1 * alpha, C2 * beta, C3 * gamma, m], 1)
    return narrow, wide, geo, nrm.reshape(nb, isect.TRI_BLOCK, 3)


def _line_meets(box, o, inv, m):
    """Per axis (near, far) of the line's slab intervals, and whether the
    line meets the boxes (the slab test with no window)."""
    near, far = [], []
    for ax in range(3):
        t0 = ((box[..., ax] - o[..., ax]) - m) * inv[..., ax]
        t1 = ((box[..., 3 + ax] - o[..., ax]) + m) * inv[..., ax]
        near.append(torch.minimum(t0, t1))
        far.append(torch.maximum(t0, t1))
    tn = torch.maximum(torch.maximum(near[0], near[1]), near[2])
    tf = torch.minimum(torch.minimum(far[0], far[1]), far[2])
    return near, far, tn <= tf


def block_keep(tri_verts, o, d, tmin, gate, steps=None):
    """(N, nb) bool: whether the kernel tests block b's triangles for lane
    i with gate[i] (or gate[i, b]): the bound on the watertight test's t
    from the narrow box's slab on the lane's dominant axis meets
    (tmin, gate), the lane's line meets the wide box, and it meets the
    narrow box too or the lane is edge-on to the block (with steps, the
    deform modes: the boxes span every step, and the narrow box or the
    edge-on test is not asked). Every triangle the plain test hits at
    tmin < t < gate lies in a kept block."""
    narrow, wide, geo, nrm = block_data(tri_verts, steps)
    narrow, wide, geo = narrow[None], wide[None], geo[None]
    inv = isect.safe_inv(d)[:, None]
    mo = o.abs().amax(1)[:, None]
    dn = torch.sqrt(_dot(d, d))[:, None]
    m = BOX_REL * mo
    near, far, n_ok = _line_meets(narrow, o[:, None], inv, m)
    w_ok = _line_meets(wide, o[:, None], inv, m)[2]
    ax, ay, az = d.abs().unbind(1)
    zmax = (az >= ax) & (az >= ay)
    ymax = ~zmax & (ay >= ax)
    kz = torch.where(zmax, 2, torch.where(ymax, 1, 0))[:, None]
    zl = torch.where(kz == 0, near[0], torch.where(kz == 1, near[1], near[2]))
    zh = torch.where(kz == 0, far[0], torch.where(kz == 1, far[1], far[2]))
    ext = zh - zl
    slack = T_REL * (zl.abs() + zh.abs())
    lower = (zl - ext) - slack
    upper = (zh + ext) + slack
    e = EPS_E * (geo[..., 3] + mo)
    thr = (geo[..., 0] + (geo[..., 1] + geo[..., 2] * e) * e) * dn
    dots = _dot(nrm[None], d[:, None, None]).abs()
    edge_on = (~(dots >= thr[..., None])).any(2)
    if gate.dim() == 1:
        gate = gate[:, None]
    if steps is not None:
        edge_on = torch.ones_like(edge_on)
    return (lower < gate) & (upper > tmin[:, None]) & w_ok \
        & (n_ok | edge_on)


def kept_blocks(mode, a, chunk=4096):
    """K1's per-lane cull in mode closest, any or dual, on the bound
    arguments `a` (a dict) of the mode's plain version (intersect_brute,
    shadow_blocked_brute, intersect_brute_occlusion): ((N, nb) bool, the
    blocks the kernel tests for each lane; (N,) int32, the triangles it
    tests, None in mode any, which stops inside a block at its first
    blocker). The gate before each block is the mode's, from the plain
    watertight test's hits in the blocks before it: a block the cull
    skips holds no hit below its gate, so it changes no gate."""
    tv, po = a["tri_verts"], a["prim_object"]
    steps = a.get("tri_verts_t1")
    if steps is not None and steps.dim() == 3:
        steps = steps[None]
    p = tv.shape[0]
    pad = (-p) % isect.TRI_BLOCK
    ov = a["object_visibility"]
    vis = a.get("visibility", a.get("visibility_closest"))
    use_vis = ov is not None and vis is not None
    pv = isect._prim_visibility(po, ov) if use_vis else None
    inf, ninf = float("inf"), -3e38

    def blocks(x, fill):   # (c, P) -> (c, nb, 8)
        x = torch.cat([x, x.new_full((x.shape[0], pad), fill)], 1)
        return x.reshape(x.shape[0], -1, isect.TRI_BLOCK)

    def before(x, op):     # exclusive scan over the blocks
        y = op(x, 1).values
        return torch.cat([torch.full_like(x[:, :1], inf if op is
                                          torch.cummin else 0), y[:, :-1]], 1)

    keep_all, tested = [], []
    for s in range(0, a["o"].shape[0], chunk):
        sl = slice(s, s + chunk)
        o, d, tmin = a["o"][sl], a["d"][sl], a["tmin"][sl]
        ws = isect.watertight_setup(o[:, None], d[:, None])
        valid, t, _u, _v = isect.wt_block(
            ws, *isect.tris_at(tv, po, steps, None if steps is None
                               else a["time"][sl]),
            tmin[:, None], RAY_TMAX)
        valid = valid & (po >= 0)[None]
        real = (po >= 0)[None].expand_as(valid)
        if mode == "dual":
            visc, visa = a["visibility_closest"][sl], a["visibility_any"][sl]
            tmaxc, tmaxa = a["tmax_closest"][sl], a["tmax_any"][sl]
            bnd = a["boundary_mask"][None]
            okc = valid & (t < tmaxc[:, None]) & ((pv & visc[:, None]) != 0)
            t_b = before(blocks(torch.where(okc & bnd, t, inf), inf)
                         .amin(2), torch.cummin).clamp(max=RAY_TMAX)
            t_o = before(blocks(torch.where(okc & ~bnd, t, inf), inf)
                         .amin(2), torch.cummin).clamp(max=RAY_TMAX)
            blk = before(blocks((valid & (t < tmaxa[:, None])
                                 & ((pv & visa[:, None]) != 0)).int(), 0)
                         .amax(2), torch.cummax) > 0
            gate = torch.maximum(
                torch.minimum(torch.maximum(t_b, t_o), tmaxc[:, None]),
                torch.where(blk, ninf, tmaxa[:, None]))
            mask = visc | visa
            live = (tmaxc > tmin) | (tmaxa > tmin)
        else:
            tmax = a["tmax"][sl]
            ok = valid & (((pv & vis[sl, None]) != 0) if use_vis else True)
            if mode == "closest":
                t0 = tmax.clamp(max=RAY_TMAX)
                gate = torch.minimum(t0[:, None], before(
                    blocks(torch.where(ok, t, inf), inf).amin(2),
                    torch.cummin))
                live = t0 > tmin
            else:
                blk = before(blocks((ok & (t < tmax[:, None])).int(), 0)
                             .amax(2), torch.cummax) > 0
                gate = torch.where(blk, ninf, tmax[:, None])
                live = tmax > tmin
            mask = vis[sl] if use_vis else None
        if mask is None:
            vis_ok = torch.ones_like(gate, dtype=torch.bool)
            tri_ok = real
        else:
            tri_ok = real & ((pv & mask[:, None]) != 0) \
                if mode != "dual" else real
            vis_ok = blocks(((pv & mask[:, None]) != 0).int(), 0).amax(2) > 0
        keep = live[:, None] & vis_ok & block_keep(tv, o, d, tmin, gate,
                                                   steps)
        keep_all.append(keep)
        tested.append((keep * blocks(tri_ok.int(), 0).sum(2)).sum(1))
    tested = torch.cat(tested).to(torch.int32)
    return torch.cat(keep_all), (None if mode == "any" else tested)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _along_edges(tv, n, rng):
    """(o, d, tmin) of n rays, in float64: each within 1e-7 to 1e-4 rad
    of one of a triangle's edges (q to r), through the line of another
    (p to q) at 0 to 0.6 of its length beyond q, from 0.5 to 50 before
    that point."""
    tri = tv[rng.integers(0, len(tv), n)]
    rot = rng.integers(0, 3, n)
    p = tri[np.arange(n), rot]
    q = tri[np.arange(n), (rot + 1) % 3]
    r = tri[np.arange(n), (rot + 2) % 3]
    e = _unit(r - q)
    g = rng.normal(size=(n, 3))
    g = _unit(g - (g * e).sum(1, keepdims=True) * e)
    d = _unit(e + (10.0 ** rng.uniform(-7, -4, n))[:, None] * g)
    x = q + rng.uniform(0.0, 0.6, n)[:, None] * (q - p)
    return x - rng.uniform(0.5, 50, n)[:, None] * d, d, 1e-4


def _rays(parts, dev):
    o = torch.tensor(np.concatenate([x for x, _, _ in parts]),
                     dtype=torch.float32, device=dev)
    d = torch.tensor(_unit(np.concatenate([x for _, x, _ in parts])),
                     dtype=torch.float32, device=dev)
    tmin = torch.tensor(np.concatenate([np.full(len(x), t) for x, _, t
                                        in parts]), dtype=torch.float32,
                        device=dev)
    return o.contiguous(), d.contiguous(), tmin


def edge_rays(tri_verts, n, seed):
    """(o, d, tmin) of n rays nearly along the triangles' edges, made from
    a seed, on tri_verts' device (the last part of grazing_rays). Such a
    ray sees the triangle nearly edge-on, where the watertight test's
    tolerance band reaches farthest outside it."""
    rng = np.random.default_rng(seed)
    tv = tri_verts.detach().cpu().numpy().astype(np.float64)
    return _rays([_along_edges(tv, n, rng)], tri_verts.device)


def grazing_rays(tri_verts, n, seed):
    """(o, d, tmin) of n unit rays that stress block_keep, made from a
    seed, on tri_verts' device: the grazing set of the tests and
    chip_smoke.py. Six parts: rays aimed at the triangles' corners and
    edge midpoints from around the scene; axis-parallel rays; rays with a
    zero direction component from the axis-aligned planes through the
    corners; rays leaving points on the triangles (tmin 1e-5, as the
    integrator's), half of them within 1e-6 to 1 of the tangent plane;
    rays that cross a triangle's plane at 1e-7 to 1e-2 rad just outside
    one of its edges (1e-4 to 1e-1 from it); and edge_rays's rays."""
    rng = np.random.default_rng(seed)
    tv = tri_verts.detach().cpu().numpy().astype(np.float64)
    corners = tv.reshape(-1, 3)
    lo, hi = corners.min(0), corners.max(0)
    span = hi - lo
    k = n // 6
    rows = np.arange(k)
    parts = []
    mids = (tv + tv[:, [1, 2, 0]]).reshape(-1, 3) / 2.0
    aim = np.concatenate([corners, mids])[rng.integers(0, 6 * len(tv), k)]
    org = rng.uniform(lo - 0.5 * span, hi + 0.5 * span, (k, 3))
    parts.append((org, aim - org, 1e-4))
    org = rng.uniform(lo + 0.01 * span, hi - 0.01 * span, (k, 3))
    d = np.zeros((k, 3))
    d[rows, rng.integers(0, 3, k)] = rng.choice([-1.0, 1.0], k)
    parts.append((org, d, 1e-4))
    d = rng.normal(size=(k, 3))
    ax = rng.integers(0, 3, k)
    d[rows, ax] = 0.0
    org = rng.uniform(lo, hi, (k, 3))
    org[rows, ax] = corners[rng.integers(0, len(corners), k), ax]
    parts.append((org, d, 1e-4))
    tri = tv[rng.integers(0, len(tv), k)]
    a, b = rng.uniform(size=(2, k))
    flip = a + b > 1.0
    a[flip], b[flip] = 1.0 - a[flip], 1.0 - b[flip]
    org = tri[:, 0] + a[:, None] * (tri[:, 1] - tri[:, 0]) \
        + b[:, None] * (tri[:, 2] - tri[:, 0])
    nrm = _unit(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    d = rng.normal(size=(k, 3))
    tang = _unit(d - (d * nrm).sum(1, keepdims=True) * nrm)
    lift = rng.choice([-1.0, 1.0], k) * 10.0 ** rng.uniform(-6, 0, k)
    d = np.where((rows % 2 == 0)[:, None], tang + lift[:, None] * nrm, d)
    parts.append((org, d, 1e-5))
    m = k
    tri = tv[rng.integers(0, len(tv), m)]
    rot = rng.integers(0, 3, m)
    p = tri[np.arange(m), rot]
    q = tri[np.arange(m), (rot + 1) % 3]
    r = tri[np.arange(m), (rot + 2) % 3]
    nrm = _unit(np.cross(q - p, r - p))
    out = np.cross(_unit(q - p), nrm)
    out = np.where(((out * (r - p)).sum(1) > 0)[:, None], -out, out)
    theta = 10.0 ** rng.uniform(-7, -2, m)
    delta = 10.0 ** rng.uniform(-4, -1, m)
    x = p + rng.uniform(0.05, 0.95, m)[:, None] * (q - p) \
        + delta[:, None] * out
    d = -np.cos(theta)[:, None] * out \
        + (rng.choice([-1.0, 1.0], m) * np.sin(theta))[:, None] * nrm
    parts.append((x - rng.uniform(20, 600, m)[:, None] * d, d, 1e-4))
    parts.append(_along_edges(tv, n - 5 * k, rng))
    return _rays(parts, tri_verts.device)


# the deform modes stage at most this many segments' deltas
# (csrc/dense_sweep.cu MAX_SEGMENTS)
MAX_SEGMENTS = 20


def _deform_rows(tri_verts, tri_verts_t1, time, n):
    """The deform modes' kernel arguments (steps (S1, P, 3, 3), S1,
    time) and their check rows, or (None, 0, None) and none."""
    kernels.require((tri_verts_t1 is None) == (time is None),
                    "tri_verts_t1 and time go together")
    if tri_verts_t1 is None:
        return (None, 0, None), []
    steps = tri_verts_t1 if tri_verts_t1.dim() == 4 else tri_verts_t1[None]
    s1, p = steps.shape[0], tri_verts.shape[0]
    kernels.unsupported(
        0 < s1 <= MAX_SEGMENTS,
        f"{s1} segments: the deform modes take at most {MAX_SEGMENTS}")
    return (steps, s1, time), [("tri_verts_t1", steps, _F, (s1, p, 3, 3)),
                               ("time", time, _F, (n,))]


def _check(tensors, n=None):
    """tensors: (name, tensor, dtype, shape) rows; shape None skips it."""
    req = kernels.require
    for name, x, dtype, shape in tensors:
        req(x.device.type == "cuda", f"{name} must be a CUDA tensor")
        req(x.is_contiguous(), f"{name} must be contiguous")
        req(x.dtype == dtype, f"{name}: wrong dtype {x.dtype}")
        if shape is not None:
            req(tuple(x.shape) == shape,
                f"{name}: shape {tuple(x.shape)}, expected {shape}")


def _tri_rows(tri_verts, prim_object, object_visibility):
    p = tri_verts.shape[0]
    kernels.require(p > 0, "the dense sweep needs at least one triangle")
    rows = [("tri_verts", tri_verts, _F, (p, 3, 3)),
            ("prim_object", prim_object, _I, (p,))]
    if object_visibility is not None:
        rows.append(("object_visibility", object_visibility, _I, None))
    return p, rows


def _ray_rows(o, d, **lanes):
    n = o.shape[0]
    return n, [("o", o, _F, (n, 3)), ("d", d, _F, (n, 3))] + [
        (k, x, _I if k.startswith("vis") else _F, (n,))
        for k, x in lanes.items() if x is not None]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _no_counts_on_cpu(counts):
    if counts:
        raise NotImplementedError("the cull's counts come from the kernel")


def _counts(counts, n, dev):
    return torch.empty((n, 3), dtype=_I, device=dev) if counts else None


def _launch(mode, fn_name, *args):
    rc = getattr(kernels.load(), fn_name)(*args, kernels.current_stream())
    kernels.check_rc(f"dense_sweep {mode}", rc)
    launches[mode] += 1


def intersect_brute_sweep(tri_verts, prim_object, o, d, tmin, tmax,
                          visibility=None, object_visibility=None,
                          tri_verts_t1=None, time=None, counts=False):
    """Dense closest hit; returns dict t, u, v (f32), prim, object (int32)
    as ops/intersect.py intersect_brute (with counts=True, (hit, counts))."""
    if o.device.type == "cpu":
        _no_counts_on_cpu(counts)
        return isect.intersect_brute(tri_verts, prim_object, o, d, tmin,
                                     tmax, visibility, object_visibility,
                                     tri_verts_t1=tri_verts_t1, time=time)
    if visibility is None or object_visibility is None:
        visibility = object_visibility = None
    p, rows = _tri_rows(tri_verts, prim_object, object_visibility)
    n, rays = _ray_rows(o, d, tmin=tmin, tmax=tmax, visibility=visibility)
    (steps, s1, time), drows = _deform_rows(tri_verts, tri_verts_t1, time, n)
    _check(rows + rays + drows)
    dev = o.device
    out = {"t": torch.empty(n, dtype=_F, device=dev),
           "prim": torch.empty(n, dtype=_I, device=dev),
           "u": torch.empty(n, dtype=_F, device=dev),
           "v": torch.empty(n, dtype=_F, device=dev),
           "object": torch.empty(n, dtype=_I, device=dev)}
    cnt = _counts(counts, n, dev)
    _launch("closest", "rt_dense_closest", tri_verts.data_ptr(),
            prim_object.data_ptr(), _ptr(object_visibility), p, o.data_ptr(),
            d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), _ptr(visibility),
            n, *(x.data_ptr() for x in out.values()), _ptr(cnt), _ptr(steps),
            s1, _ptr(time))
    return (out, cnt) if counts else out


def shadow_blocked_sweep(tri_verts, prim_object, o, d, tmin, tmax,
                         visibility=None, object_visibility=None,
                         tri_verts_t1=None, time=None, counts=False):
    """Dense any hit: (N,) bool, as ops/intersect.py shadow_blocked_brute
    (with counts=True, (blocked, counts))."""
    if o.device.type == "cpu":
        _no_counts_on_cpu(counts)
        return isect.shadow_blocked_brute(tri_verts, prim_object, o, d, tmin,
                                          tmax, visibility, object_visibility,
                                          tri_verts_t1=tri_verts_t1,
                                          time=time)
    if visibility is None or object_visibility is None:
        visibility = object_visibility = None
    p, rows = _tri_rows(tri_verts, prim_object, object_visibility)
    n, rays = _ray_rows(o, d, tmin=tmin, tmax=tmax, visibility=visibility)
    (steps, s1, time), drows = _deform_rows(tri_verts, tri_verts_t1, time, n)
    _check(rows + rays + drows)
    blocked = torch.empty(n, dtype=_B, device=o.device)
    cnt = _counts(counts, n, o.device)
    _launch("any", "rt_dense_any", tri_verts.data_ptr(),
            prim_object.data_ptr(), _ptr(object_visibility), p, o.data_ptr(),
            d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), _ptr(visibility),
            n, blocked.data_ptr(), _ptr(cnt), _ptr(steps), s1, _ptr(time))
    return (blocked, cnt) if counts else blocked


def occlusion_sweep(tri_verts, prim_object, boundary_mask, o, d, tmin,
                    tmax_closest, tmax_any, visibility_closest,
                    visibility_any, object_visibility, tri_verts_t1=None,
                    time=None, counts=False):
    """The volume NEE's dual form: (t_boundary, t_other, blocked), as
    ops/intersect.py intersect_brute_occlusion (with counts=True, the
    counts follow as a fourth element)."""
    if o.device.type == "cpu":
        _no_counts_on_cpu(counts)
        return isect.intersect_brute_occlusion(
            tri_verts, prim_object, boundary_mask, o, d, tmin, tmax_closest,
            tmax_any, visibility_closest, visibility_any, object_visibility,
            tri_verts_t1=tri_verts_t1, time=time)
    p, rows = _tri_rows(tri_verts, prim_object, object_visibility)
    rows.append(("boundary_mask", boundary_mask, _B, (p,)))
    n, rays = _ray_rows(o, d, tmin=tmin, tmax_closest=tmax_closest,
                        tmax_any=tmax_any,
                        visibility_closest=visibility_closest,
                        visibility_any=visibility_any)
    (steps, s1, time), drows = _deform_rows(tri_verts, tri_verts_t1, time, n)
    _check(rows + rays + drows)
    dev = o.device
    t_b = torch.empty(n, dtype=_F, device=dev)
    t_o = torch.empty(n, dtype=_F, device=dev)
    blocked = torch.empty(n, dtype=_B, device=dev)
    cnt = _counts(counts, n, dev)
    _launch("dual", "rt_dense_dual", tri_verts.data_ptr(),
            prim_object.data_ptr(), object_visibility.data_ptr(),
            boundary_mask.data_ptr(), p, o.data_ptr(), d.data_ptr(),
            tmin.data_ptr(), tmax_closest.data_ptr(), tmax_any.data_ptr(),
            visibility_closest.data_ptr(), visibility_any.data_ptr(), n,
            t_b.data_ptr(), t_o.data_ptr(), blocked.data_ptr(), _ptr(cnt),
            _ptr(steps), s1, _ptr(time))
    return (t_b, t_o, blocked, cnt) if counts else (t_b, t_o, blocked)


def intersect_mt_sweep(tri_v0, tri_e1, tri_e2, o, d, tmin, tmax):
    """Dense closest hit in the TPU kernel's Moeller-Trumbore arithmetic
    on (nb, 8, 3) triangle packets; returns dict t, prim, u, v as
    ops/intersect.py intersect_brute_mt."""
    if o.device.type == "cpu":
        return isect.intersect_brute_mt(tri_v0, tri_e1, tri_e2, o, d, tmin,
                                        tmax)
    nb = tri_v0.shape[0]
    kernels.require(nb > 0, "the dense sweep needs at least one packet")
    shape = (nb, isect.TRI_BLOCK, 3)
    n, rays = _ray_rows(o, d, tmin=tmin, tmax=tmax)
    _check([("tri_v0", tri_v0, _F, shape), ("tri_e1", tri_e1, _F, shape),
            ("tri_e2", tri_e2, _F, shape)] + rays)
    dev = o.device
    out = {"t": torch.empty(n, dtype=_F, device=dev),
           "prim": torch.empty(n, dtype=_I, device=dev),
           "u": torch.empty(n, dtype=_F, device=dev),
           "v": torch.empty(n, dtype=_F, device=dev)}
    _launch("mt", "rt_dense_mt", tri_v0.data_ptr(), tri_e1.data_ptr(),
            tri_e2.data_ptr(), nb * isect.TRI_BLOCK, o.data_ptr(),
            d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
            *(x.data_ptr() for x in out.values()))
    return out
