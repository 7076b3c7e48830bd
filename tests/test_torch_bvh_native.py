"""The port's C++ BVH builder (raytracingproject_tpu_torch/native/
bvh_builder.cpp, which bvh/build.py build_bvh takes from 2,048 prims on)
against the JAX package's (raytracingproject_tpu/native/bvh_builder.cpp,
through raytracingproject_tpu.native.build_bvh_native).

The JAX package's builder recurses on a second thread where a node's two
children both hold more than 4,096 prims under depth 4, and both threads
append to one node list and one prim list, so its node and prim numbering
changes from build to build there. The port's copy has no thread. Hence
two kinds of check:

- exact: on inputs of at most 8,193 prims, where the reference never
  takes the thread, the port's bounds, children and prim_order are equal
  to the reference's array for array: the prim boxes of
  instanced_scene(grid=3), seeded random boxes, a set of repeated
  triangles whose centroids coincide (the median split of degenerate
  centroids) and a set of boxes too large for a finite SAH cost (the
  median split when no bin split is found);
- relabelled: at 8,450 and 13,202 prims (instanced_scene at grid=4 and
  grid=5) both trees numbered depth-first, left child first (node bounds
  in visit order, each leaf's prims in visit order) are equal, in each of
  three reference builds; and every subtree of the port's tree holds one
  contiguous range of prim_order, which bvh/clusters.py cut_clusters
  relies on.

Every comparison is exact (no tolerance): both builders do the same
float32 arithmetic in the same order."""

import numpy as np
import pytest

from raytracingproject_tpu import native as jnative
from raytracingproject_tpu.bvh import build as jbuild
from raytracingproject_tpu_torch import native
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.bvh import build

# builds of the reference per relabelled input
REFERENCE_BUILDS = 3


def scene_boxes(grid):
    """The prim boxes the port's host compile hands to the builder for
    instanced_scene(grid=grid), which compiles flattened up to grid=5."""
    s = tex.instanced_scene(16, 16, spp=2, grid=grid)
    verts = np.concatenate([
        s._mesh_arrays(o.geometry, oi, np.asarray(o.transform, np.float32))
        ["verts"] for oi, o in enumerate(s.objects)]).astype(np.float32)
    return verts.min(1), verts.max(1)


def random_boxes(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-50.0, 50.0, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 2.0, (n, 3)).astype(np.float32)
    return c - h, c + h


def degenerate_boxes():
    """2,400 copies of one triangle's box and 48 random boxes: once the
    copies are alone in a node, the centroid extent is 0 and the builders
    take the median split (std::nth_element)."""
    rng = np.random.default_rng(11)
    lo = np.tile(np.array([[1.0, 2.0, 3.0]], np.float32), (2400, 1))
    hi = np.tile(np.array([[1.5, 2.25, 3.5]], np.float32), (2400, 1))
    rlo, rhi = random_boxes(48, 12)
    lo, hi = np.concatenate([lo, rlo]), np.concatenate([hi, rhi])
    perm = rng.permutation(len(lo))
    return lo[perm], hi[perm]


def unbounded_cost_boxes():
    """3,000 boxes of half-size 1e19 around distinct centres spread over
    +-1e20: every half area overflows float32, so every SAH cost is inf,
    no bin split wins (best < 0) and the builders split at the median
    (std::nth_element) in every node."""
    rng = np.random.default_rng(13)
    c = rng.uniform(-1e20, 1e20, (3000, 3)).astype(np.float32)
    return c - np.float32(1e19), c + np.float32(1e19)


EXACT = {
    "instanced_grid3": lambda: scene_boxes(3),
    "random_2048": lambda: random_boxes(2048, 3),
    "random_6000": lambda: random_boxes(6000, 5),
    "degenerate_centroids": degenerate_boxes,
    "unbounded_sah": unbounded_cost_boxes,
}


def reference(lo, hi):
    res = jnative.build_bvh_native(lo, hi, build.MAX_LEAF_SIZE)
    assert res is not None, "the JAX package's native builder did not load"
    return res


def decode(child):
    v = -int(child) - 1
    return v >> 4, v & 15


def relabel(bounds, children, order):
    """The tree numbered depth-first, left child first: per node in visit
    order its bounds and, per child, "inner" or the leaf's prims (original
    indices, in leaf order)."""
    out = []
    stack = [0]
    while stack:
        node = stack.pop()
        kids = []
        for c in children[node]:
            if c >= 0:
                kids.append("inner")
            else:
                s, n = decode(c)
                kids.append(tuple(int(p) for p in order[s:s + n]))
        out.append((bounds[node].tobytes(), tuple(kids)))
        stack.extend(int(c) for c in children[node][::-1] if c >= 0)
    return out


def prim_ranges(children):
    """(first, last + 1, prims) of the prim_order positions under each
    node, children before parents."""
    rng = {}

    def visit(node):
        lo, hi, count = np.inf, -np.inf, 0
        for c in children[node]:
            if c >= 0:
                a, b, n = visit(int(c))
            else:
                a, n = decode(c)
                b = a + n
            if n:
                lo, hi, count = min(lo, a), max(hi, b), count + n
        rng[node] = (lo, hi, count)
        return rng[node]

    visit(0)
    return rng


@pytest.fixture(scope="module")
def scene_sets():
    return {g: scene_boxes(g) for g in (4, 5)}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_matches_reference(name):
    lo, hi = EXACT[name]()
    assert build.NATIVE_MIN_PRIMS <= len(lo) <= 8193
    got = build.build_bvh(lo, hi)
    ref = reference(lo, hi)
    for key, r in zip(("bounds", "children", "prim_order"), ref):
        g = getattr(got, key)
        assert g.dtype == r.dtype and g.shape == r.shape, key
        np.testing.assert_array_equal(g, r, err_msg=key)
    np.testing.assert_array_equal(got.root_bound_lo, lo.min(0))
    np.testing.assert_array_equal(got.root_bound_hi, hi.max(0))
    assert sorted(got.prim_order.tolist()) == list(range(len(lo)))


def test_inputs_reach_the_median_splits():
    """The two sets meant for the median splits do reach them: identical
    centroids beyond a leaf's size, and an SAH cost that is inf."""
    lo, hi = degenerate_boxes()
    cent = 0.5 * (lo + hi)
    _, counts = np.unique(cent, axis=0, return_counts=True)
    assert counts.max() > 100 * build.MAX_LEAF_SIZE
    lo, hi = unbounded_cost_boxes()
    d = (hi - lo).astype(np.float32)
    with np.errstate(over="ignore"):
        area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    assert np.isinf(area).all()
    cent = 0.5 * (lo + hi)
    assert len(np.unique(cent[:, 0])) == len(lo)


@pytest.mark.parametrize("grid, nprims", [(4, 8450), (5, 13202)])
def test_relabelled_matches_reference(scene_sets, grid, nprims):
    lo, hi = scene_sets[grid]
    assert len(lo) == nprims
    got = build.build_bvh(lo, hi)
    again = build.build_bvh(lo, hi)
    for key in ("bounds", "children", "prim_order"):
        np.testing.assert_array_equal(getattr(got, key), getattr(again, key))
    mine = relabel(got.bounds, got.children, got.prim_order)
    for _ in range(REFERENCE_BUILDS):
        ref = reference(lo, hi)
        assert len(ref[0]) == len(got.bounds)
        assert relabel(*ref) == mine


@pytest.mark.parametrize("grid", [4, 5])
def test_subtrees_are_contiguous(scene_sets, grid):
    lo, hi = scene_sets[grid]
    got = build.build_bvh(lo, hi)
    for node, (a, b, n) in prim_ranges(got.children).items():
        assert n > 0 and b - a == n, f"node {node}: positions [{a}, {b}) " \
            f"hold {n} prims"
    assert prim_ranges(got.children)[0] == (0, len(lo), len(lo))


def test_numpy_builder_below_the_switch():
    """Below NATIVE_MIN_PRIMS both packages build with NumPy, from it on
    with C++: at 2,047 and 2,048 prims the port equals the JAX package's
    build_bvh."""
    lo, hi = random_boxes(2048, 17)
    for n in (build.NATIVE_MIN_PRIMS - 1, build.NATIVE_MIN_PRIMS):
        got = build.build_bvh(lo[:n], hi[:n])
        ref = jbuild.build_bvh(lo[:n], hi[:n])
        for key in ("bounds", "children", "prim_order"):
            np.testing.assert_array_equal(getattr(got, key),
                                          getattr(ref, key), err_msg=key)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s own message; nothing falls
    back to the NumPy builder."""
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("int rtp_build_bvh( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    assert not list((tmp_path / "out").glob("*.so"))


def test_build_is_named_by_source_and_flags(monkeypatch):
    """The library's name hashes the source and the flags, so an edit of
    either builds anew."""
    path = native._out_path()
    assert path.startswith(native.BUILD_DIR)
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-g"])
    assert native._out_path() != path
