"""BVH tree cut into triangle clusters (JAX counterpart:
raytracingproject_tpu/bvh/clusters.py cut_clusters :25,
group_superclusters :105, supercluster_bounds :136).

The port's own copy: the cluster walks (ops/cluster_intersect.py and the
CUDA kernels) read a flat list of clusters, each a maximal BVH subtree of
<= cluster_tris prims. The builder's depth-first prim_order makes every
subtree a contiguous prim range, so a cluster is (start, count). Big
scenes add a second level: consecutive clusters grouped into
superclusters, each a row of `sc_bounds` (the two-level walk K5,
ops/cluster2_walk.py).
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.bvh.build import decode_leaf


def cut_clusters(children, cluster_tris):
    """Cut tree at maximal subtrees with <= cluster_tris prims.

    children: (M, 2) i32 BVH2 child array (root = node 0).
    Returns list of (start, count) prim ranges (contiguous, in
    prim_order space), covering every prim exactly once.
    """
    m = len(children)
    if m == 0:
        return []

    # subtree prim range per node, computed iteratively (deep BVHs
    # overflow Python recursion)
    ranges = {}

    def node_range(i):
        # iterative post-order
        stack = [(i, False)]
        while stack:
            n, done = stack.pop()
            if n in ranges:
                continue
            c0, c1 = int(children[n][0]), int(children[n][1])
            kids = [c for c in (c0, c1) if c >= 0]
            if not done and kids:
                stack.append((n, True))
                stack.extend((c, False) for c in kids if c not in ranges)
                continue
            lo, hi = None, None

            def acc(lo, hi, s, c):
                if c == 0:
                    return lo, hi
                lo = s if lo is None else min(lo, s)
                hi = s + c if hi is None else max(hi, s + c)
                return lo, hi

            for c in (c0, c1):
                if c >= 0:
                    s2, c2 = ranges[c]
                    lo, hi = acc(lo, hi, s2, c2)
                else:
                    s2, c2 = decode_leaf(c)
                    lo, hi = acc(lo, hi, s2, c2)
            ranges[n] = (0, 0) if lo is None else (lo, hi - lo)
        return ranges[i]

    node_range(0)

    # top-down cut: take maximal subtrees small enough
    out = []
    stack = [0]
    while stack:
        n = stack.pop()
        s, c = ranges[n]
        if c == 0:
            continue
        if c <= cluster_tris:
            out.append((s, c))
            continue
        for ch in (int(children[n][0]), int(children[n][1])):
            if ch >= 0:
                stack.append(ch)
            else:
                s2, c2 = decode_leaf(ch)
                if c2 > 0:
                    # an oversize leaf cannot happen (builder leaf size
                    # << cluster_tris) but split defensively
                    for k in range(0, c2, cluster_tris):
                        out.append((s2 + k, min(cluster_tris, c2 - k)))
    out.sort()
    # verify full disjoint coverage
    end = 0
    for s, c in out:
        assert s == end, f"cluster ranges not contiguous: {s} != {end}"
        end = s + c
    return out


def group_superclusters(cluster_ranges, super_ranges, gmax):
    """Group clusters into superclusters.

    cluster_ranges / super_ranges: sorted contiguous (start, count) prim
    ranges from cut_clusters at a fine and a coarse budget on the same
    tree, so every cluster nests inside exactly one super range. Groups
    bigger than gmax are split into consecutive chunks. Returns
    [(cstart, gcount)] in cluster-index space, covering every cluster
    once, each gcount <= gmax."""
    groups = []
    ci = 0
    for (ss, sc) in super_ranges:
        c0 = ci
        send = ss + sc
        while ci < len(cluster_ranges) and cluster_ranges[ci][0] < send:
            s, c = cluster_ranges[ci]
            assert s >= ss and s + c <= send, \
                f"cluster {(s, c)} not nested in super {(ss, sc)}"
            ci += 1
        for k in range(c0, ci, gmax):
            groups.append((k, min(gmax, ci - k)))
    assert ci == len(cluster_ranges), "clusters left ungrouped"
    return groups


def supercluster_bounds(cb_lo_hi, groups):
    """(SC, 8) supercluster rows: the union box of the group's cluster
    bounds, then (cstart, gcount) as float32. cb_lo_hi: (C, 6)."""
    out = np.zeros((len(groups), 8), np.float32)
    for i, (cs, gc) in enumerate(groups):
        out[i, 0:3] = cb_lo_hi[cs:cs + gc, 0:3].min(0)
        out[i, 3:6] = cb_lo_hi[cs:cs + gc, 3:6].max(0)
        out[i, 6] = cs
        out[i, 7] = gc
        assert cs < (1 << 24) and gc < (1 << 24)
    return out
