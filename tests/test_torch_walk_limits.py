"""The capacity of the single-level walks and the dispatch around it, on
the CPU, without JAX.

K2 (ops/cluster_walk.py) and K7 (ops/dual_walk.py) keep a 9-bit cluster
id in their packed visit keys and take at most 512 clusters; K3
(ops/occlusion_walk.py) and K4 (ops/tile_walk.py) take the JAX package's
single-level cap of 640. The integrator picks K2 + K3 up to 512 clusters
and K4 + K3 from 513 to 640, as the JAX package does (its one-hot tables
pack only up to 512), and fused NEE (K7) only up to 512. Past 640 the
host compile builds two-level tables (K5). A capacity limit raises
NotImplementedError; a wrong device, dtype or shape raises ValueError.
The wrappers are reached on `meta` tensors, which are neither CPU tensors
(the plain version) nor CUDA tensors (the kernel).

The cases marked `cuda` run the kernels on the card: K2 and K3 with
counts=True against the plain launch, and K3 and K4 on a 640-cluster
table against their plain versions. On the GPU machine:
    python -m pytest tests/test_torch_walk_limits.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.app import examples
from raytracingproject_tpu_torch.models import scene as msc
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk as k2
from raytracingproject_tpu_torch.ops import dual_walk as k7
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
from raytracingproject_tpu_torch.ops import tile_walk as k4

torch.set_num_threads(1)

CT = 15
ROWS = (179, 512, 513, 600, 640, 641)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kg(c):
    """A single-level kg whose dscene has c cluster rows (meta tensors)."""
    ds = {"cluster_bounds": _meta(c, 6),
          "cluster_table": _meta(c, ci.row_width(CT)),
          "cluster_boundary": _meta(c, CT),
          "light_dist_type": _meta(1)}
    return {"dscene": ds, "cluster_tris": CT, "use_brute": False,
            "features": {}, "fused_nee": True}


def _rays(n=4):
    return _meta(n, 3), _meta(n), _meta(n, dtype=torch.int32)


@pytest.fixture
def called(monkeypatch):
    """Replace the closest-hit and occlusion wrappers by recorders: the
    list gets each called wrapper's module name."""
    calls = []
    for mod, fn in ((k2, "intersect_clusters_walk"),
                    (k4, "intersect_clusters_tile"),
                    (k3, "occlusion_clusters_walk")):
        name = mod.__name__.rsplit(".", 1)[1]
        monkeypatch.setattr(mod, fn,
                            lambda *a, _n=name, **kw: calls.append(_n))
    monkeypatch.setattr(k5, "intersect_clusters2_walk",
                        lambda *a, **kw: calls.append("cluster2_walk"))
    return calls


@pytest.mark.parametrize("c", ROWS)
def test_dispatch_by_cluster_count(c, called):
    """K2 + K3 up to 512 clusters, K4 + K3 from 513 (and K4's own refusal
    past 640, which the host compile never reaches); fused NEE only up to
    512."""
    kg = _kg(c)
    closest = "cluster_walk" if c <= 512 else "tile_walk"
    assert integ._closest_walk_name(kg) == closest
    assert integ._use_occlusion_walk(kg)
    assert integ._use_fused_nee(kg) == (c <= 512)
    o, t, vis = _rays()
    integ._scene_intersect_tris(kg, o, o, t, t, vis)
    integ._occlusion(kg, o, o, t, t, t)
    assert called == [closest, "occlusion_walk"]


@pytest.mark.parametrize("c", (179, 600))
def test_dispatch_flags(c, called):
    """pallas_onehot off takes K4 at any count; both flags off leave the
    plain walk, which the card refuses."""
    kg = {**_kg(c), "pallas_onehot": False}
    assert integ._closest_walk_name(kg) == "tile_walk"
    assert not integ._use_fused_nee(kg)
    kg["pallas_clusters"] = False
    assert integ._closest_walk_name(kg) is None
    o, t, vis = _rays()
    with pytest.raises(NotImplementedError, match="plain cluster walk"):
        integ._scene_intersect_tris(kg, o, o, t, t, vis)
    assert called == []


@pytest.mark.parametrize("limit, two_level", [(640, False), (100, False),
                                              (20, True)])
def test_host_compile_cap(monkeypatch, called, limit, two_level):
    """The host compile tries clusters of 16, 32 and 64 triangles and
    builds two-level tables when none fits CLUSTER_MAX_SINGLE_LEVEL, K3's
    and K4's capacity; those go to K5 and never to K3 (the glossy box's
    1,932 prims with the cap lowered stand in for a big scene)."""
    assert msc.CLUSTER_MAX_SINGLE_LEVEL == k3.MAX_CLUSTERS == k4.MAX_CLUSTERS
    monkeypatch.setattr(msc, "CLUSTER_MAX_SINGLE_LEVEL", limit)
    s = examples.cornell_box(8, 8, spheres="glossy")
    s.device_update()
    kg = s.make_kernel_globals("cpu")
    c = int(kg["dscene"]["cluster_bounds"].shape[0])
    assert ("sc_bounds" in kg["dscene"]) == two_level
    assert int(kg["cluster_tris"]) == {640: 15, 100: 32, 20: 46}[limit]
    assert two_level or c <= limit
    assert integ._use_occlusion_walk(kg) == (not two_level)
    o = torch.zeros((4, 3))
    t = torch.zeros(4)
    integ._scene_intersect_tris(kg, o, o, t, t,
                                torch.ones(4, dtype=torch.int32))
    assert called == ["cluster2_walk" if two_level else "cluster_walk"]


def _k2(c):
    o, t, vis = _rays()
    return k2.intersect_clusters_walk(_meta(c, 6), _meta(c, ci.row_width(CT)),
                                      CT, o, o, t, t, vis)


def _k4(c):
    o, t, vis = _rays()
    return k4.intersect_clusters_tile(_meta(c, 6), _meta(c, ci.row_width(CT)),
                                      CT, o, o, t, t, vis)


def _k3(c):
    o, t, _vis = _rays()
    return k3.occlusion_clusters_walk(
        _meta(c, 6), _meta(c, ci.row_width(CT)), _meta(c, CT), CT, o, o, t,
        t, t, 1, 128)


def _k7(c):
    o, t, vis = _rays()
    return k7.intersect_clusters_dual_walk(
        _meta(c, 6), _meta(c, ci.row_width(CT)), CT, o, o, t, t, vis, o, o, t,
        t, vis)


WRAPPERS = {"K2": (_k2, 512), "K7": (_k7, 512), "K3": (_k3, 640),
            "K4": (_k4, 640)}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
@pytest.mark.parametrize("c", (179, 600, 641))
def test_capacity_raises_not_implemented(kernel, c):
    """Past a kernel's capacity: NotImplementedError, before the device
    check; within it the meta tensors reach the device check (ValueError,
    as tests/test_torch_intersect.py and the others expect at 179)."""
    fn, cap = WRAPPERS[kernel]
    if c > cap:
        with pytest.raises(NotImplementedError, match="clusters"):
            fn(c)
    else:
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(c)


def test_k3_shared_memory_and_fits():
    """K2's capacity is fits(); K3's block (bounds, and per warp a staged
    row, its rays and results) needs no opt-in past 48 KB at 640 clusters
    of up to 64 triangles."""
    assert k2.fits(1) and k2.fits(512)
    assert not k2.fits(0) and not k2.fits(513)
    assert k3.smem_bytes(640, 64) <= k3.SMEM_BYTES == 48 * 1024
    assert k3.smem_bytes(640, 15) == (640 * 6 + 4 * (180 + 544 + 96)) * 4


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_counts_need_the_kernel(kernel):
    """counts=True runs the kernel's counting variant: the plain version
    has no counts, so CPU tensors refuse it."""
    o = torch.zeros((4, 3))
    t = torch.zeros(4)
    cb = torch.zeros((2, 6))
    ctab = torch.zeros((2, ci.row_width(CT)))
    with pytest.raises(NotImplementedError, match="counts"):
        if kernel == "K2":
            k2.intersect_clusters_walk(cb, ctab, CT, o, o, t, t,
                                       torch.ones(4, dtype=torch.int32),
                                       counts=True)
        else:
            k3.occlusion_clusters_walk(cb, ctab, torch.zeros((2, CT)), CT, o,
                                       o, t, t, t, 1, 128, counts=True)


# ---- on the card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def grid_tables(c, ct, seed, dev):
    """A single-level table of c clusters of ct random triangles: cluster
    k's triangles lie in a cube of side 20 on a grid of pitch 30, its
    boundary flags are random. Returns (cbounds, ctable, cboundary)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(c ** (1.0 / 3.0)))
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)[:c] * 30.0
    verts = (cells[:, None, None, :]
             + rng.uniform(0.0, 20.0, (c, ct, 3, 3))).astype(np.float32)
    clusters = [{"verts": verts[k], "prim": np.arange(k * ct, (k + 1) * ct),
                 "obj": np.full(ct, k % 7, np.int32),
                 "vis": np.full(ct, 129, np.int32),
                 "lo": verts[k].reshape(-1, 3).min(0),
                 "hi": verts[k].reshape(-1, 3).max(0)} for k in range(c)]
    cb, ctab, _ = ci.pack_cluster_table(clusters)
    cbd = (rng.uniform(size=(c, ct)) < 0.3).astype(np.float32)
    return (torch.tensor(cb, device=dev), torch.tensor(ctab, device=dev),
            torch.tensor(cbd, device=dev))


def grid_rays(n, side, seed, dev):
    """Rays from uniform origins around a grid of `side` cells, isotropic
    directions, mixed windows: (o, d, tmin, tmax_closest, tmax_any)."""
    rng = np.random.default_rng(seed)
    span = 30.0 * side
    o = rng.uniform(-0.25 * span, 1.25 * span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmaxc = rng.uniform(10, 2 * span, n).astype(np.float32)
    tmaxa = np.where(rng.uniform(size=n) < 0.5, rng.uniform(10, span, n),
                     1e30).astype(np.float32)
    return tuple(torch.tensor(x, device=dev) for x in
                 (o, d, np.full(n, 1e-4, np.float32), tmaxc, tmaxa))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_k2_counts_against_the_plain_launch(any_hit):
    dev = _cuda()
    cb, ctab, _ = grid_tables(179, CT, 1, dev)
    o, d, tmin, _, _ = grid_rays(8192, 6, 2, dev)
    args = (cb, ctab, CT, o, d, tmin, torch.full_like(tmin, 1e30),
            torch.ones(8192, dtype=torch.int32, device=dev))
    plain = k2.intersect_clusters_walk(*args, shadow_any_hit=any_hit)
    hit, cnt = k2.intersect_clusters_walk(*args, shadow_any_hit=any_hit,
                                          counts=True)
    assert all(torch.equal(plain[k], hit[k]) for k in plain)
    rows, boxes = cnt[:, 0], cnt[:, 1]
    assert cnt.shape == (8192, 2) and bool((rows >= 0).all())
    # every pass tests all C boxes, and a lane makes at least one pass
    assert bool((boxes % 179 == 0).all()) and bool((boxes >= 179).all())
    assert bool((rows[hit["prim"] >= 0] >= 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["surface", "dual"])
def test_k3_counts_against_the_plain_launch(form):
    dev = _cuda()
    cb, ctab, cbd = grid_tables(179, CT, 3, dev)
    o, d, tmin, tmaxc, tmaxa = grid_rays(8192, 6, 4, dev)
    if form == "surface":
        tmaxc = tmin
    args = (cb, ctab, cbd, CT, o, d, tmin, tmaxc, tmaxa, 1, 128)
    plain = k3.occlusion_clusters_walk(*args)
    out, cnt = k3.occlusion_clusters_walk(*args, counts=True)
    assert all(torch.equal(a, b) for a, b in zip(plain, out))
    rows, boxes, staged = cnt[:, 0], cnt[:, 1], cnt[:, 2]
    assert cnt.shape == (8192, 3)
    assert bool((rows <= boxes).all()) and bool((boxes <= 179).all())
    assert bool((rows <= staged).all()) and bool((staged <= 179).all())
    assert bool((rows[out[2]] >= 1).all())


@pytest.mark.cuda
def test_k3_k4_at_640_clusters():
    """At the single-level cap K3 equals its plain version to the bit and
    K4 agrees with its own (prim and object off exact-t ties)."""
    dev = _cuda()
    cb, ctab, cbd = grid_tables(640, CT, 5, dev)
    o, d, tmin, tmaxc, tmaxa = grid_rays(16384, 9, 6, dev)
    args = (cb, ctab, cbd, CT, o, d, tmin, tmaxc, tmaxa, 1, 128)
    got = k3.occlusion_clusters_walk(*args)
    ref = ci.occlusion_clusters(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    vis = torch.ones(16384, dtype=torch.int32, device=dev)
    wargs = (cb, ctab, CT, o, d, tmin, tmaxc, vis)
    got = k4.intersect_clusters_tile(*wargs)
    ref = ci.intersect_clusters(*wargs)
    assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    same = got["prim"] == ref["prim"]
    assert float(same.float().mean()) >= 1.0 - 1e-4
    assert torch.equal(got["t"][same], ref["t"][same])
