"""BVH tree cut into triangle clusters (JAX counterpart:
raytracingproject_tpu/bvh/clusters.py cut_clusters :25).

The port's own copy: the cluster walks (ops/cluster_intersect.py and the
CUDA kernels) read a flat list of clusters, each a maximal BVH subtree of
<= cluster_tris prims. The builder's depth-first prim_order makes every
subtree a contiguous prim range, so a cluster is (start, count).
"""

from __future__ import annotations

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
