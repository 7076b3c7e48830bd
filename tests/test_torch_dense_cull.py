"""K1's cull (ops/dense_sweep.py block_keep, csrc/dense_sweep.cu
keep_block) on the CPU, without JAX.

The kernel tests a block of 8 triangles for a lane only where block_keep
holds at the lane's gate. These tests hold the design's arithmetic; the
kernel itself is held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

- test_block_keep_is_conservative, over the scene (cornell_diffuse's 36
  triangles, volume_sss's 1,008), the render mode (closest, any, dual)
  and the ray set (pixel-centre camera rays; bounce rays from their hits;
  the grazing set of ops/dense_sweep.py grazing_rays): every (lane,
  triangle) pair that the plain watertight test hits inside
  (tmin, RAY_TMAX) lies in a block that block_keep keeps at gate = that
  hit's t (so at every gate above it: block_keep only grows with the
  gate). Then the kernel's sweep, written in torch block by block (the
  blocks that ops/dense_sweep.py kept_blocks keeps for each lane, the
  plain version run on them only), equals the plain version of the mode
  to the bit;
- test_block_keep_edge_on: the same first assertion on 20,000 rays
  nearly along the triangles' edges, on both scenes (a cull that assumes
  the test accepts only within a few ulps of the triangle drops hits
  there);
- test_block_keep_culls: on volume_sss's camera rays, at the final
  closest t, under 10% of the blocks are kept (a pad so large that nothing
  is culled fails it);
- counts=True needs the kernel: CPU tensors refuse it, for K1's three
  render modes and for K7.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.app import examples
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import dense_sweep as k1
from raytracingproject_tpu_torch.ops import dual_walk as k7
from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.utils.math import RAY_TMAX

torch.set_num_threads(1)

SIDE = 24        # 24 x 24 camera rays
N_GRAZING = 1000
N_EDGE = 20000
B = isect.TRI_BLOCK
VIS = np.array([1, 8, 16, 4, 128], np.int32)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(tri_verts, prim_object, object_visibility, boundary, kg) of a
    use_brute scene; cornell gets a seeded boundary mask planted."""
    s = examples.cornell_box(SIDE, SIDE, spp=2) if name == "cornell" \
        else examples.volume_sss_scene(SIDE, SIDE, spp=2)
    s.device_update()
    kg = s.make_kernel_globals("cpu")
    ds = kg["dscene"]
    assert kg["use_brute"]
    bnd = ds["prim_is_boundary"]
    if not bool(bnd.any()):
        bnd = torch.tensor(np.random.default_rng(2).uniform(
            size=bnd.shape[0]) < 0.3)
    return (ds["tri_verts_world"], ds["prim_object_packed"],
            ds["object_visibility"], bnd, kg)


def _camera(kg):
    cam = dict(kg["cam"])
    yy, xx = np.mgrid[0:SIDE, 0:SIDE]
    rx = torch.tensor((xx.reshape(-1) + 0.5) * cam["width"] / SIDE,
                      dtype=torch.float32)
    ry = torch.tensor((yy.reshape(-1) + 0.5) * cam["height"] / SIDE,
                      dtype=torch.float32)
    z = torch.zeros_like(rx)
    ray = cam_ops.camera_sample_ray(cam, rx, ry, z, z, z)
    return ray["o"].contiguous(), ray["d"].contiguous()


@functools.lru_cache(maxsize=None)
def _rays(name, rays):
    """(o, d, tmin) of a ray set."""
    tv, po, _ov, _bnd, kg = _scene(name)
    if rays == "grazing":
        return k1.grazing_rays(tv, N_GRAZING, 11)
    o, d = _camera(kg)
    n = o.shape[0]
    if rays == "camera":
        return o, d, torch.zeros(n)
    hit = isect.intersect_brute(tv, po, o, d, torch.zeros(n),
                                torch.full((n,), RAY_TMAX))
    keep = hit["prim"] >= 0
    p = (o + hit["t"][:, None] * d)[keep]
    tri = tv[hit["prim"][keep].long()]
    nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm = torch.where(((nrm * d[keep]).sum(1) > 0)[:, None], -nrm, nrm)
    rng = np.random.default_rng(3)
    nd = torch.tensor(rng.normal(size=(p.shape[0], 3)).astype(np.float32))
    nd = nd / nd.norm(dim=1, keepdim=True)
    nd = torch.where(((nd * nrm).sum(1) < 0)[:, None], -nd, nd)
    return p.contiguous(), nd.contiguous(), torch.full((p.shape[0],), 1e-5)


def _windows(n, tmin, seed):
    """Mode windows and masks: tmax (a tenth empty), tmax_any (half
    finite, a tenth empty), tmax_c, mixed visibility, shadow visibility."""
    r = np.random.default_rng(seed)
    empty = torch.tensor(r.uniform(size=n) < 0.1)
    tmax = torch.where(empty, tmin, RAY_TMAX)
    tmax_any = torch.tensor(np.where(r.uniform(size=n) < 0.5,
                                     r.uniform(10, 800, n), RAY_TMAX)
                            .astype(np.float32))
    tmax_any = torch.where(torch.tensor(r.uniform(size=n) < 0.1), tmin,
                           tmax_any)
    tmax_c = torch.tensor(r.uniform(10, 1000, n).astype(np.float32))
    tmax_c = torch.where(empty, tmin, tmax_c)
    vis = torch.tensor(VIS[r.integers(0, len(VIS), n)])
    return tmax, tmax_any, tmax_c, vis, torch.full((n,), 128,
                                                   dtype=torch.int32)


def _args(mode, tv, po, ov, bnd, o, d, tmin, w):
    """The bound arguments of the mode's plain version."""
    tmax, tmax_any, tmax_c, vis, vis_a = w
    a = {"tri_verts": tv, "prim_object": po, "o": o, "d": d, "tmin": tmin,
         "object_visibility": ov}
    if mode == "closest":
        return {**a, "tmax": tmax, "visibility": vis}
    if mode == "any":
        return {**a, "tmax": tmax_any, "visibility": vis_a}
    return {**a, "boundary_mask": bnd, "tmax_closest": tmax_c,
            "tmax_any": tmax_any, "visibility_closest": vis,
            "visibility_any": vis_a}


def _culled_sweep(mode, tv, po, ov, bnd, o, d, tmin, w):
    """The kernel's sweep in torch: blocks in order, each tested (by the
    plain version, on its own triangles) only by the lanes that keep it
    (ops/dense_sweep.py kept_blocks: block_keep at the mode's gate before
    the block, and the visibility OR); the block results merged as the
    kernel merges them."""
    tmax, tmax_any, tmax_c, vis, vis_a = w
    n = o.shape[0]
    kept = k1.kept_blocks(mode, _args(mode, tv, po, ov, bnd, o, d, tmin,
                                      w))[0]
    bt = torch.clamp(tmax, max=RAY_TMAX)
    t_b = torch.full((n,), RAY_TMAX)
    t_o = torch.full((n,), RAY_TMAX)
    prim = torch.full((n,), -1, dtype=torch.int32)
    obj = torch.full((n,), -1, dtype=torch.int32)
    u, v = torch.zeros(n), torch.zeros(n)
    blocked = torch.zeros(n, dtype=torch.bool)
    for b in range(kept.shape[1]):
        sl = slice(b * B, b * B + B)
        keep = kept[:, b]
        if mode == "closest":
            r = isect.intersect_brute(tv[sl], po[sl], o, d, tmin,
                                      torch.where(keep, bt, tmin), vis, ov)
            got = keep & (r["prim"] >= 0)
            bt = torch.where(got, r["t"], bt)
            prim = torch.where(got, r["prim"] + b * B, prim)
            obj = torch.where(got, r["object"], obj)
            u = torch.where(got, r["u"], u)
            v = torch.where(got, r["v"], v)
        elif mode == "any":
            blocked = blocked | (keep & isect.shadow_blocked_brute(
                tv[sl], po[sl], o, d, tmin,
                torch.where(keep, tmax_any, tmin), vis_a, ov))
        else:
            rb, ro, rk = isect.intersect_brute_occlusion(
                tv[sl], po[sl], bnd[sl], o, d, tmin,
                torch.where(keep, tmax_c, tmin),
                torch.where(keep, tmax_any, tmin), vis, vis_a, ov)
            t_b = torch.minimum(t_b, rb)
            t_o = torch.minimum(t_o, ro)
            blocked = blocked | rk
    if mode == "closest":
        return {"t": bt, "prim": prim, "u": u, "v": v, "object": obj}
    if mode == "any":
        return blocked
    return t_b, t_o, blocked


def _plain(mode, tv, po, ov, bnd, o, d, tmin, w):
    tmax, tmax_any, tmax_c, vis, vis_a = w
    if mode == "closest":
        return isect.intersect_brute(tv, po, o, d, tmin, tmax, vis, ov)
    if mode == "any":
        return isect.shadow_blocked_brute(tv, po, o, d, tmin, tmax_any,
                                          vis_a, ov)
    return isect.intersect_brute_occlusion(tv, po, bnd, o, d, tmin, tmax_c,
                                           tmax_any, vis, vis_a, ov)


def _dropped(tv, o, d, tmin):
    """(N,) bool: lanes with a hit of the plain watertight test inside
    (tmin, RAY_TMAX) in a block that block_keep drops at gate = that
    hit's t; and the number of hits."""
    n = o.shape[0]
    ws = isect.watertight_setup(o[:, None], d[:, None])
    v0 = tv[None, :, 0]
    hit, t, _u, _v = isect.wt_block(
        ws, v0.unbind(-1), (tv[None, :, 1] - v0).unbind(-1),
        (tv[None, :, 2] - v0).unbind(-1), tmin[:, None], RAY_TMAX)
    tb = torch.where(hit, t, torch.tensor(float("inf")))
    tb = torch.cat([tb, tb.new_full((n, (-tv.shape[0]) % B), float("inf"))],
                   1).reshape(n, -1, B).amin(2)
    held = tb < float("inf")
    keep = k1.block_keep(tv, o, d, tmin, torch.where(held, tb, 0.0))
    return (held & ~keep).any(1), int(hit.sum())


@pytest.mark.parametrize("rays", ["camera", "bounce", "grazing"])
@pytest.mark.parametrize("mode", ["closest", "any", "dual"])
@pytest.mark.parametrize("scene", ["cornell", "volume_sss"])
def test_block_keep_is_conservative(scene, mode, rays):
    tv, po, ov, bnd, _kg = _scene(scene)
    o, d, tmin = _rays(scene, rays)
    n = o.shape[0]
    # every hit of the plain watertight test, at its own t
    dropped, hits = _dropped(tv, o, d, tmin)
    assert hits >= n // 4, "the ray set hits too little"
    assert not bool(dropped.any()), \
        f"{int(dropped.sum())} lanes lost a block with a hit in it"
    # the sweep with the cull equals the plain version to the bit
    w = _windows(n, tmin, zlib.crc32(f"{scene} {mode} {rays}".encode()))
    ref = _plain(mode, tv, po, ov, bnd, o, d, tmin, w)
    got = _culled_sweep(mode, tv, po, ov, bnd, o, d, tmin, w)
    if mode == "closest":
        assert bool((ref["prim"] >= 0).any())
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    elif mode == "any":
        assert bool(ref.any())
        assert torch.equal(got, ref)
    else:
        assert bool((ref[0] < RAY_TMAX).any() and ref[2].any())
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("scene", ["cornell", "volume_sss"])
def test_block_keep_edge_on(scene):
    """20,000 rays nearly along the triangles' edges (edge_rays): a
    triangle seen within ~1e-6 rad of edge-on is hit up to a fraction of
    its size outside its edges, past a pad of a few ulps; block_keep
    keeps its block all the same."""
    tv = _scene(scene)[0]
    o, d, tmin = k1.edge_rays(tv, N_EDGE, 5)
    hits = 0
    for s in range(0, N_EDGE, 5000):
        sl = slice(s, s + 5000)
        dropped, h = _dropped(tv, o[sl], d[sl], tmin[sl])
        hits += h
        assert not bool(dropped.any()), \
            f"{int(dropped.sum())} lanes lost a block with a hit in it"
    assert hits >= N_EDGE // 4, "the ray set hits too little"


def test_block_keep_culls():
    tv, po, _ov, _bnd, _kg = _scene("volume_sss")
    o, d, tmin = _rays("volume_sss", "camera")
    n = o.shape[0]
    hit = isect.intersect_brute(tv, po, o, d, tmin, torch.full((n,),
                                                               RAY_TMAX))
    keep = k1.block_keep(tv, o, d, tmin, hit["t"])
    share = float(keep.float().mean())
    assert 0.0 < share < 0.10, share


def _cpu_rays(n=4):
    return torch.zeros((n, 3)), torch.zeros(n), torch.ones(n,
                                                           dtype=torch.int32)


@pytest.mark.parametrize("kernel", ["K1 closest", "K1 any", "K1 dual", "K7"])
def test_counts_need_the_kernel(kernel):
    """counts=True runs a kernel's counting variant: the plain versions
    have no counts, so CPU tensors refuse it."""
    o, t, vis = _cpu_rays()
    tv = torch.zeros((8, 3, 3))
    po = torch.zeros(8, dtype=torch.int32)
    ov = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="counts"):
        if kernel == "K1 closest":
            k1.intersect_brute_sweep(tv, po, o, o, t, t, vis, ov, counts=True)
        elif kernel == "K1 any":
            k1.shadow_blocked_sweep(tv, po, o, o, t, t, vis, ov, counts=True)
        elif kernel == "K1 dual":
            k1.occlusion_sweep(tv, po, torch.zeros(8, dtype=torch.bool), o, o,
                               t, t, t, vis, vis, ov, counts=True)
        else:
            ct = 15
            k7.intersect_clusters_dual_walk(
                torch.zeros((2, 6)), torch.zeros((2, ci.row_width(ct))), ct,
                o, o, t, t, vis, o, o, t, t, vis, counts=True)
