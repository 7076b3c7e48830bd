"""Binned-SAH BVH2 builder and the float32 golden triangle test (JAX
counterpart: raytracingproject_tpu/bvh/build.py build_bvh :75,
_wt_intersect_np :260).

The port's own copy of the JAX package's NumPy builder: the same binning,
the same SAH leaf test and the same depth-first child order, so a scene
compiles to bit-identical tables in both packages
(tests/test_torch_scene.py). At 2,048 prims and more the JAX package
switches to its C++ builder (native/bvh_builder.cpp); that builder is not
part of the port yet, so `build_bvh` raises there instead of building a
different tree.

Node layout: bounds (M, 12) f32 -- child0 lo/hi, child1 lo/hi;
children (M, 2) i32 -- >= 0 an inner child, < 0 a leaf encoding
(prim_start, count) as -(1 + (start << 4) + count). Prims are reordered
so each leaf's prims are contiguous (prim_order).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_BINS = 16
MAX_LEAF_SIZE = 4
# prim count at which the JAX package hands the build to its C++ builder
NATIVE_MIN_PRIMS = 2048


def encode_leaf(start, count):
    return -(1 + (int(start) << 4) + int(count))


def decode_leaf(child):
    v = -int(child) - 1
    return v >> 4, v & 15


@dataclass
class BVHArrays:
    bounds: np.ndarray     # (M, 12) f32
    children: np.ndarray   # (M, 2) i32
    prim_order: np.ndarray  # (P,) i32: new position -> original prim index
    root_bound_lo: np.ndarray
    root_bound_hi: np.ndarray


def build_bvh(lo, hi, max_leaf_size=MAX_LEAF_SIZE):
    """Build a BVH2 over primitives with AABBs [lo, hi] ((P, 3) each);
    returns BVHArrays."""
    lo = np.asarray(lo, np.float32).reshape(-1, 3)
    hi = np.asarray(hi, np.float32).reshape(-1, 3)
    nprims = len(lo)
    if nprims >= NATIVE_MIN_PRIMS:
        raise NotImplementedError(
            f"{nprims} prims: the C++ BVH builder (used from "
            f"{NATIVE_MIN_PRIMS} prims on) is not ported")

    cent = 0.5 * (lo + hi)

    if nprims == 0:
        bounds = np.zeros((1, 12), np.float32)
        children = np.full((1, 2), encode_leaf(0, 0), np.int32)
        return BVHArrays(bounds, children, np.zeros(0, np.int32),
                         np.zeros(3, np.float32), np.zeros(3, np.float32))

    order = np.arange(nprims, dtype=np.int32)

    bounds_list = []
    children_list = []
    prim_out = []

    def new_node():
        bounds_list.append(np.zeros(12, np.float32))
        children_list.append(np.zeros(2, np.int32))
        return len(bounds_list) - 1

    def leaf_child(idx_range):
        start = len(prim_out)
        prim_out.extend(order[idx_range].tolist())
        return encode_leaf(start, len(idx_range))

    def range_bounds(idx):
        return lo[idx].min(0), hi[idx].max(0)

    def split_range(idx):
        """Pick SAH binned split; returns (left_idx, right_idx) or None
        for make-leaf. (ref: bvh_binning.cpp bin_splits)"""
        n = len(idx)
        if n <= max_leaf_size:
            return None
        clo = cent[idx].min(0)
        chi = cent[idx].max(0)
        ext = chi - clo
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # Degenerate centroids: median split to bound leaf size.
            half = n // 2
            return idx[:half], idx[half:]
        # bin primitives along the widest centroid axis
        scale = NUM_BINS * (1.0 - 1e-6) / ext[axis]
        bin_ids = ((cent[idx, axis] - clo[axis]) * scale).astype(np.int32)
        # per-bin counts and bounds via vectorized min/max-at
        counts = np.bincount(bin_ids, minlength=NUM_BINS)
        blo = np.full((NUM_BINS, 3), np.inf, np.float32)
        bhi = np.full((NUM_BINS, 3), -np.inf, np.float32)
        np.minimum.at(blo, bin_ids, lo[idx])
        np.maximum.at(bhi, bin_ids, hi[idx])
        # sweep left->right and right->left for SAH
        def areas(l, h):
            d = np.maximum(h - l, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        llo = np.minimum.accumulate(blo, 0)
        lhi = np.maximum.accumulate(bhi, 0)
        rlo = np.minimum.accumulate(blo[::-1], 0)[::-1]
        rhi = np.maximum.accumulate(bhi[::-1], 0)[::-1]
        lcount = np.cumsum(counts)
        # split after bin i: left = bins[0..i], right = bins[i+1..]
        rcount = n - lcount[:-1]
        sah = (areas(llo, lhi)[:-1] * lcount[:-1]
               + areas(rlo, rhi)[1:] * rcount)
        valid = (lcount[:-1] > 0) & (rcount > 0)
        if not valid.any():
            half = n // 2
            part = np.argsort(cent[idx, axis], kind="stable")
            return idx[part[:half]], idx[part[half:]]
        sah = np.where(valid, sah, np.inf)
        best = int(np.argmin(sah))
        mask = bin_ids <= best
        left, right = idx[mask], idx[~mask]
        # SAH leaf test (ref: bvh_build.cpp:572-600): compare split cost
        # against leaf cost when the range could still be a leaf.
        # (disabled for max_leaf_size == 1, e.g. TLAS instance leaves)
        if max_leaf_size > 1 and n <= 8:  # LEAF_UNROLL bound
            plo, phi = range_bounds(idx)
            whole = max(areas(plo[None], phi[None])[0], 1e-20)
            leaf_cost = n
            split_cost = 0.125 + (sah[best] / whole)
            if split_cost >= leaf_cost:
                return None
        return left, right

    # iterative top-down build (explicit stack avoids recursion limits)
    root = new_node()
    stack = [(root, order)]
    while stack:
        node_id, idx = stack.pop()
        sp = split_range(idx)
        if sp is None:
            # single-leaf node: child0 = leaf, child1 = empty leaf
            b = np.zeros(12, np.float32)
            plo, phi = range_bounds(idx)
            b[0:3], b[3:6] = plo, phi
            b[6:9], b[9:12] = np.inf, -np.inf  # empty child1 never hits
            bounds_list[node_id] = b
            children_list[node_id] = np.array(
                [leaf_child(idx), encode_leaf(0, 0)], np.int32)
            continue
        left, right = sp
        b = np.zeros(12, np.float32)
        llo_, lhi_ = range_bounds(left)
        rlo_, rhi_ = range_bounds(right)
        b[0:3], b[3:6] = llo_, lhi_
        b[6:9], b[9:12] = rlo_, rhi_
        bounds_list[node_id] = b
        kids = np.zeros(2, np.int32)
        # child creation: leaf if small enough post-split
        for k, part in enumerate((left, right)):
            if len(part) <= max_leaf_size:
                kids[k] = leaf_child(part)
            else:
                cid = new_node()
                kids[k] = cid
                stack.append((cid, part))
        children_list[node_id] = kids

    bounds = np.asarray(bounds_list, np.float32)
    children = np.asarray(children_list, np.int32)
    prim_order = np.asarray(prim_out, np.int32)
    rlo, rhi = lo.min(0), hi.max(0)
    return BVHArrays(bounds, children, prim_order, rlo, rhi)


# ---------------------------------------------------------------------------
# Golden single-ray triangle test (the tests hold the torch and CUDA
# watertight tests against it)
# ---------------------------------------------------------------------------

def _wt_intersect_np(tri, o, d):
    """float32 NumPy twin of ops/intersect.py watertight_setup/_test
    (ref: util/util_math_intersect.h:88) — the golden single-ray
    triangle test. Same shear-basis formulation, same operation order,
    all in np.float32 so results match the device kernel bit-for-bit."""
    f = np.float32
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    tri = np.asarray(tri, np.float32)
    ad = np.abs(d)
    if ad[2] >= ad[0] and ad[2] >= ad[1]:
        kz = 2
    elif ad[1] >= ad[0]:
        kz = 1
    else:
        kz = 0
    if ad.max() == 0.0:
        return None, 0, 0
    if d[kz] < 0.0:
        kx, ky = (kz + 2) % 3, (kz + 1) % 3
    else:
        kx, ky = (kz + 1) % 3, (kz + 2) % 3
    inv_kz = f(1.0) / d[kz]
    sx, sy, sz = d[kx] * inv_kz, d[ky] * inv_kz, inv_kz
    ex = np.zeros(3, np.float32)
    ey = np.zeros(3, np.float32)
    ez = np.zeros(3, np.float32)
    ex[kx] = 1.0
    ey[ky] = 1.0
    ez[kz] = 1.0
    rx = ex - sx * ez
    ry = ey - sy * ez
    rz = sz * ez
    rxo = f(rx[0] * o[0] + rx[1] * o[1] + rx[2] * o[2])
    ryo = f(ry[0] * o[0] + ry[1] * o[1] + ry[2] * o[2])
    rzo = f(rz[0] * o[0] + rz[1] * o[1] + rz[2] * o[2])

    def shear(v):
        return (f(rx[0] * v[0] + rx[1] * v[1] + rx[2] * v[2]) - rxo,
                f(ry[0] * v[0] + ry[1] * v[1] + ry[2] * v[2]) - ryo,
                f(rz[0] * v[0] + rz[1] * v[1] + rz[2] * v[2]) - rzo)

    axs, ays, azs = shear(tri[0])
    bxs, bys, bzs = shear(tri[1])
    cxs, cys, czs = shear(tri[2])
    eps = f(4.0 * 2.0 ** -23)  # = ops/intersect.py _WT_EPS

    def edge(px, py, qx, qy):
        p1, p2 = f(px * qy), f(py * qx)
        return f(p1 - p2), f(eps * (abs(p1) + abs(p2)))

    w_a, tol_a = edge(bxs, bys, cxs, cys)
    w_b, tol_b = edge(cxs, cys, axs, ays)
    w_c, tol_c = edge(axs, ays, bxs, bys)
    sign_ok = (w_a >= -tol_a and w_b >= -tol_b and w_c >= -tol_c) \
        or (w_a <= tol_a and w_b <= tol_b and w_c <= tol_c)
    det = f(w_a + w_b + w_c)
    if not sign_ok or det == 0.0:
        return None, 0, 0
    inv = f(1.0) / det
    t = f(f(w_a * azs + w_b * bzs + w_c * czs) * inv)
    u = min(max(f(w_b * inv), f(0.0)), f(1.0))
    v = min(max(f(w_c * inv), f(0.0)), f(1.0))
    return (t, u, v) if t > 0 else (None, 0, 0)
