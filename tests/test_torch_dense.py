"""The dense sweep (K1's contract) in plain torch against the JAX package:

- host compile: the dense-path arrays (tri_verts_world, prim_object_packed,
  object_visibility, prim_is_boundary) of cornell_diffuse (36 prims, no
  cluster tables) and volume_sss (1,008 prims) equal the JAX package's,
  and survive kg_from_jax;
- `intersect_brute`, `shadow_blocked_brute` and `intersect_brute_occlusion`
  (ops/intersect.py) against the JAX functions of the same names on
  cornell (a planted boundary mask), volume_sss (its real
  prim_is_boundary) and the 37 random triangles of tests/test_pallas.py, on seeded random rays and camera
  rays with mixed per-lane visibility and some empty windows: hit masks
  and prims equal, t rtol 1e-5, u and v atol 1e-5. XLA:CPU contracts
  multiply-adds in the watertight test, so at an exact edge or a window's
  end the JAX functions may pick the neighbour or round t apart; at most
  EDGE_FRAC of the lanes may differ so, and there the port's t must
  equal, bit for bit, the float32 numpy golden without contraction
  (bvh/build.py _wt_intersect_np) on the port's own prim;
- `intersect_brute_mt` against the JAX package's TPU kernel
  intersect_brute_pallas in interpret mode on one 1,024-ray tile: prims
  equal, t rtol 1e-5;
- the wrappers of ops/dense_sweep.py take the plain versions on CPU
  tensors, count no launch there, and refuse what the kernel does not
  take."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import intersect as jisect
from raytracingproject_tpu.ops import pallas_intersect as pi
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.bvh.build import _wt_intersect_np
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.models.scene import (
    KG_ARRAYS, KG_DENSE, kg_from_jax)
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.ops import dense_sweep as k1
from raytracingproject_tpu_torch.ops import intersect as tisect
from raytracingproject_tpu_torch.utils.math import RAY_TMAX

torch.set_num_threads(1)
KG_CLUSTER = ("cluster_bounds", "cluster_table", "cluster_boundary")
N_RANDOM = 1536
SIDE = 24          # 24 x 24 camera rays
EDGE_FRAC = 0.01
SCENES = ("cornell", "volume_sss", "random37")
VIS = (ob.PATH_RAY_CAMERA, ob.PATH_RAY_DIFFUSE, ob.PATH_RAY_GLOSSY,
       ob.PATH_RAY_TRANSMIT, ob.PATH_RAY_SHADOW)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX kernel globals, port kernel globals) of an example scene."""
    make = {"cornell": lambda ex: ex.cornell_box(SIDE, SIDE, spp=2),
            "volume_sss": lambda ex: ex.volume_sss_scene(SIDE, SIDE, spp=2)}
    js, ts = make[name](jex), make[name](tex)
    js.device_update()
    ts.device_update()
    return js.make_kernel_globals(device_put=False), \
        ts.make_kernel_globals("cpu")


@functools.lru_cache(maxsize=None)
def _case(name):
    """The dense arrays and rays of a scene, as numpy: tri_verts,
    prim_object, object_visibility (int32), boundary, and o, d, tmin,
    tmax, tmax_any, vis, vis_any."""
    r = np.random.default_rng(5)
    if name == "random37":
        base = np.random.default_rng(3).uniform(-6, 6, (37, 1, 3))
        tv = (base + np.random.default_rng(4).uniform(
            -1, 1, (37, 3, 3))).astype(np.float32)
        po = r.integers(0, 3, 37).astype(np.int32)
        # object 1 is invisible to shadow rays, object 2 to glossy ones
        ov = np.array([ob.PATH_RAY_ALL_VISIBILITY,
                       ob.PATH_RAY_ALL_VISIBILITY & ~ob.PATH_RAY_SHADOW,
                       ob.PATH_RAY_ALL_VISIBILITY & ~ob.PATH_RAY_GLOSSY],
                      np.int32)
        bnd = r.uniform(size=37) < 0.3
        o = r.uniform(-8, 8, (N_RANDOM, 3)).astype(np.float32)
        cam_o = np.zeros((0, 3), np.float32)
        cam_d = cam_o
    else:
        _jkg, tkg = _pair(name)
        ds = tkg["dscene"]
        tv = ds["tri_verts_world"].numpy()
        po = ds["prim_object_packed"].numpy()
        ov = ds["object_visibility"].numpy()
        bnd = ds["prim_is_boundary"].numpy()
        if not bnd.any():
            # cornell has no volume: plant a seeded boundary mask, so that
            # both minima of the dual form are exercised
            bnd = r.uniform(size=len(po)) < 0.3
        o = r.uniform(-300, 900, (N_RANDOM, 3)).astype(np.float32)
        yy, xx = np.mgrid[0:SIDE, 0:SIDE]
        rx = torch.tensor(xx.reshape(-1) + 0.5, dtype=torch.float32)
        ry = torch.tensor(yy.reshape(-1) + 0.5, dtype=torch.float32)
        z = torch.zeros_like(rx)
        ray = cam_ops.camera_sample_ray(tkg["cam"], rx, ry, z, z, z)
        cam_o, cam_d = ray["o"].numpy(), ray["d"].numpy()
    d = r.normal(size=(N_RANDOM, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = np.concatenate([o, cam_o]), np.concatenate([d, cam_d])
    n = len(o)
    tmin = np.full(n, 1e-4, np.float32)
    scale = 12.0 if name == "random37" else 700.0
    # a third of the windows end inside the scene, a tenth are empty
    kind = r.uniform(size=n)
    tmax = np.where(kind < 0.33, r.uniform(0.05, 1.0, n) * scale,
                    RAY_TMAX).astype(np.float32)
    tmax = np.where(kind > 0.9, tmin, tmax).astype(np.float32)
    kind2 = r.uniform(size=n)
    tmax_any = np.where(kind2 < 0.5, r.uniform(0.05, 1.0, n) * scale,
                        RAY_TMAX).astype(np.float32)
    tmax_any = np.where(kind2 > 0.9, np.float32(1e-5),
                        tmax_any).astype(np.float32)
    vis = np.array(VIS, np.int32)[r.integers(0, len(VIS), n)]
    vis_any = np.array([ob.PATH_RAY_SHADOW, ob.PATH_RAY_CAMERA],
                       np.int32)[r.integers(0, 2, n)]
    return {"tv": tv, "po": po, "ov": ov, "bnd": bnd, "o": o, "d": d,
            "tmin": tmin, "tmax": tmax, "tmax_any": tmax_any, "vis": vis,
            "vis_any": vis_any}


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a, dtype=None):
    return jnp.asarray(a, dtype)


def _golden_t(tv, prim, o, d):
    """float32 numpy t of ray (o, d) on triangle `prim`, its corners
    rebuilt from the edge layout as the sweeps do."""
    v = tv[prim]
    tri = np.stack([v[0], v[0] + (v[1] - v[0]), v[0] + (v[2] - v[0])])
    return _wt_intersect_np(tri, o, d)[0]


# ---- host compile ----

@pytest.mark.parametrize("scene", ["cornell", "volume_sss"])
@pytest.mark.parametrize("name", KG_DENSE + ("prim_is_boundary",))
def test_dense_arrays_equal(scene, name):
    jkg, tkg = _pair(scene)
    ref = np.asarray(jkg["dscene"][name])
    got = tkg["dscene"][name].numpy()
    assert ref.shape == got.shape
    # uint32 bit masks are int32 on the torch side
    assert got.dtype == (np.int32 if ref.dtype == np.uint32 else ref.dtype)
    np.testing.assert_array_equal(ref, got)


def test_cornell_compile_matches_jax():
    """36 prims: use_brute, no cluster tables in either package, every
    other table equal, and kg_from_jax carries the dense arrays."""
    jkg, tkg = _pair("cornell")
    assert tkg["use_brute"] is True and jkg["use_brute"] is True
    assert tkg["cluster_tris"] == 0
    for k in KG_CLUSTER:
        assert k not in jkg["dscene"] and k not in tkg["dscene"], k
    for k in KG_ARRAYS:
        if k not in KG_CLUSTER:
            np.testing.assert_array_equal(np.asarray(jkg["dscene"][k]),
                                          tkg["dscene"][k].numpy(), k)
    assert tkg["dscene"]["tri_verts_world"].shape == (36, 3, 3)
    ckg = kg_from_jax(jkg, "cpu")
    for k in KG_DENSE + ("prim_is_boundary",):
        assert torch.equal(ckg["dscene"][k], tkg["dscene"][k]), k
    assert ckg["use_brute"] is True


def test_volume_sss_dense_tables():
    _jkg, tkg = _pair("volume_sss")
    ds = tkg["dscene"]
    assert tkg["use_brute"] is True
    assert ds["tri_verts_world"].shape == (1008, 3, 3)
    assert int(ds["prim_is_boundary"].sum()) == 12
    # the smoke box is volume-only: invisible to shadow rays
    ov = ds["object_visibility"]
    assert int(((ov & ob.PATH_RAY_SHADOW) == 0).sum()) == 1


# ---- the three sweeps against the JAX functions ----

def _check_edges(c, bad, got_t, got_prim):
    """Lanes where the two packages disagree: few, and the port's t is
    the uncontracted golden's on its own prim."""
    assert bad.mean() <= EDGE_FRAC, bad.mean()
    for i in np.nonzero(bad)[0]:
        if got_prim[i] >= 0:
            assert got_t[i] == _golden_t(c["tv"], got_prim[i], c["o"][i],
                                         c["d"][i]), i


@pytest.mark.parametrize("scene", SCENES)
def test_intersect_brute_vs_jax(scene):
    c = _case(scene)
    ref = jisect.intersect_brute(
        _j(c["tv"]), _j(c["po"]), _j(c["o"]), _j(c["d"]), _j(c["tmin"]),
        _j(c["tmax"]), visibility=_j(c["vis"], jnp.uint32),
        object_visibility=_j(c["ov"], jnp.uint32))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tisect.intersect_brute(
        _t(c["tv"]), _t(c["po"]), _t(c["o"]), _t(c["d"]), _t(c["tmin"]),
        _t(c["tmax"]), visibility=_t(c["vis"]),
        object_visibility=_t(c["ov"]))
    got = {k: v.numpy() for k, v in got.items()}
    hit = got["prim"] >= 0
    assert 0.01 < hit.mean() < 0.9
    empty = c["tmax"] <= c["tmin"]
    assert empty.any() and not hit[empty].any()
    same = (ref["prim"] == got["prim"]) & (ref["object"] == got["object"])
    close = same & np.isclose(got["t"], ref["t"], rtol=1e-5, atol=0.0) \
        & np.isclose(got["u"], ref["u"], rtol=0.0, atol=1e-5) \
        & np.isclose(got["v"], ref["v"], rtol=0.0, atol=1e-5)
    np.testing.assert_array_equal(got["t"][~hit & same],
                                  ref["t"][~hit & same])
    _check_edges(c, ~close, got["t"], got["prim"])
    np.testing.assert_array_equal(
        got["object"][hit], c["po"][got["prim"][hit]])


@pytest.mark.parametrize("scene", SCENES)
def test_intersect_brute_without_visibility(scene):
    """The signature's optional masks left out, as tests/test_pallas.py
    calls it."""
    c = _case(scene)
    n = 512
    a = [c[k][:n] for k in ("o", "d", "tmin", "tmax")]
    ref = jisect.intersect_brute(_j(c["tv"]), _j(c["po"]),
                                 *(_j(x) for x in a))
    got = tisect.intersect_brute(_t(c["tv"]), _t(c["po"]),
                                 *(_t(x) for x in a))
    bad = np.asarray(ref["prim"]) != got["prim"].numpy()
    c = {**c, "o": a[0], "d": a[1]}
    _check_edges(c, bad, got["t"].numpy(), got["prim"].numpy())
    np.testing.assert_allclose(got["t"].numpy()[~bad],
                               np.asarray(ref["t"])[~bad], rtol=1e-5)


@pytest.mark.parametrize("scene", SCENES)
def test_shadow_blocked_brute_vs_jax(scene):
    c = _case(scene)
    shadow = np.full(len(c["o"]), ob.PATH_RAY_SHADOW, np.int32)
    ref = np.asarray(jisect.shadow_blocked_brute(
        _j(c["tv"]), _j(c["po"]), _j(c["o"]), _j(c["d"]), _j(c["tmin"]),
        _j(c["tmax_any"]), visibility=_j(shadow, jnp.uint32),
        object_visibility=_j(c["ov"], jnp.uint32)))
    got = tisect.shadow_blocked_brute(
        _t(c["tv"]), _t(c["po"]), _t(c["o"]), _t(c["d"]), _t(c["tmin"]),
        _t(c["tmax_any"]), visibility=_t(shadow),
        object_visibility=_t(c["ov"])).numpy()
    assert got.dtype == np.bool_ and 0.005 < got.mean() < 0.9
    assert (ref != got).mean() <= EDGE_FRAC
    # the closest hit under the same mask and window agrees with it
    hit = tisect.intersect_brute(
        _t(c["tv"]), _t(c["po"]), _t(c["o"]), _t(c["d"]), _t(c["tmin"]),
        _t(c["tmax_any"]), visibility=_t(shadow),
        object_visibility=_t(c["ov"]))
    np.testing.assert_array_equal(got, hit["prim"].numpy() >= 0)


@pytest.mark.parametrize("scene", SCENES)
def test_intersect_brute_occlusion_vs_jax(scene):
    c = _case(scene)
    ref = jisect.intersect_brute_occlusion(
        _j(c["tv"]), _j(c["po"]), _j(c["bnd"]), _j(c["o"]), _j(c["d"]),
        _j(c["tmin"]), _j(c["tmax"]), _j(c["tmax_any"]),
        _j(c["vis"], jnp.uint32), _j(c["vis_any"], jnp.uint32),
        _j(c["ov"], jnp.uint32))
    got = tisect.intersect_brute_occlusion(
        _t(c["tv"]), _t(c["po"]), _t(c["bnd"]), _t(c["o"]), _t(c["d"]),
        _t(c["tmin"]), _t(c["tmax"]), _t(c["tmax_any"]), _t(c["vis"]),
        _t(c["vis_any"]), _t(c["ov"]))
    (rb, ro, rblk), (gb, go, gblk) = (
        [np.asarray(x) for x in ref], [x.numpy() for x in got])
    assert (gb < RAY_TMAX).any() and (go < RAY_TMAX).any() and gblk.any()
    bad = (rblk != gblk) | ~np.isclose(gb, rb, rtol=1e-5, atol=0.0) \
        | ~np.isclose(go, ro, rtol=1e-5, atol=0.0)
    assert bad.mean() <= EDGE_FRAC
    # the two minima are the closest hits over each half of the prims
    for mask, t_half in ((c["bnd"], gb), (~c["bnd"], go)):
        po = np.where(mask, c["po"], -1).astype(np.int32)
        hit = tisect.intersect_brute(
            _t(c["tv"]), _t(po), _t(c["o"]), _t(c["d"]), _t(c["tmin"]),
            _t(c["tmax"]), visibility=_t(c["vis"]),
            object_visibility=_t(c["ov"]))
        found = hit["prim"].numpy() >= 0
        np.testing.assert_array_equal(t_half[found], hit["t"].numpy()[found])
        assert (t_half[~found] == np.float32(RAY_TMAX)).all()


def test_edge_ties_follow_the_block_rule():
    """Rays straight down onto the shared diagonal of a quad hit both of
    its triangles at one t. Inside a block of 8 the higher index wins;
    across blocks the earlier block does. As the JAX function."""
    def quad(x0):
        a, b, c, e = ([x0, 0, 0], [x0 + 4, 0, 0], [x0 + 4, 4, 0],
                      [x0, 4, 0])
        return [[a, b, c], [a, c, e]]

    tv = np.zeros((16, 3, 3), np.float32)
    tv[0:2] = quad(0.0)       # both in block 0
    tv[7:9] = quad(8.0)       # one in block 0, one in block 1
    po = np.zeros(16, np.int32)
    k = np.array([1.0, 2.0, 3.0], np.float32)
    o = np.concatenate([np.stack([k, k, 0 * k + 5], 1),
                        np.stack([8 + k, k, 0 * k + 5], 1)])
    d = np.tile(np.array([[0, 0, -1]], np.float32), (6, 1))
    tmin, tmax = np.zeros(6, np.float32), np.full(6, 1e30, np.float32)
    ref = jisect.intersect_brute(_j(tv), _j(po), _j(o), _j(d), _j(tmin),
                                 _j(tmax))
    got = tisect.intersect_brute(_t(tv), _t(po), _t(o), _t(d), _t(tmin),
                                 _t(tmax))
    assert got["prim"].tolist() == [1, 1, 1, 7, 7, 7]
    for key in ("prim", "t", "u", "v"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    # each triangle of a pair is hit on its own, at the same t
    for alone in (0, 1, 7, 8):
        one = np.where(np.arange(16) == alone, 0, -1).astype(np.int32)
        h = tisect.intersect_brute(_t(tv), _t(one), _t(o), _t(d), _t(tmin),
                                   _t(tmax))
        lanes = slice(0, 3) if alone < 2 else slice(3, 6)
        assert (h["prim"][lanes] == alone).all()
        assert torch.equal(h["t"][lanes], got["t"][lanes])


# ---- the TPU kernel's own contract ----

def test_mt_plain_vs_pallas_kernel():
    """intersect_brute_mt against intersect_brute_pallas(interpret=True)
    on one 1,024-ray tile and the 37 random triangles (5 packets), half
    the windows ending inside the scene."""
    c = _case("random37")
    n = pi.TILE
    pad = (-len(c["tv"])) % pi.TRI_BLOCK
    tv = np.pad(c["tv"], ((0, pad), (0, 0), (0, 0)))
    packets = [tv[:, 0].reshape(-1, pi.TRI_BLOCK, 3),
               (tv[:, 1] - tv[:, 0]).reshape(-1, pi.TRI_BLOCK, 3),
               (tv[:, 2] - tv[:, 0]).reshape(-1, pi.TRI_BLOCK, 3)]
    rays = [c[k][:n] for k in ("o", "d", "tmin", "tmax")]
    ref = pi.intersect_brute_pallas(*(_j(x) for x in packets + rays),
                                    interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tisect.intersect_brute_mt(*(_t(x) for x in packets + rays))
    got = {k: v.numpy() for k, v in got.items()}
    hit = got["prim"] >= 0
    assert 0.01 < hit.mean() < 0.9 and got["prim"].max() < 37
    np.testing.assert_array_equal(got["prim"], ref["prim"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-5)
    np.testing.assert_allclose(got["u"][hit], ref["u"][hit], atol=1e-5)
    np.testing.assert_allclose(got["v"][hit], ref["v"][hit], atol=1e-5)
    # where both contracts see a clean hit they name the same triangle
    wt = tisect.intersect_brute(_t(c["tv"]), _t(np.zeros(37, np.int32)),
                                *(_t(x) for x in rays))["prim"].numpy()
    assert (wt == got["prim"]).mean() > 0.99


# ---- the wrappers ----

def _torch_args(c, n=256):
    return (_t(c["tv"]), _t(c["po"])), tuple(
        _t(c[k][:n]) for k in ("o", "d", "tmin", "tmax"))


def test_wrappers_take_the_plain_versions_on_cpu():
    c = _case("cornell")
    tri, rays = _torch_args(c)
    vis, ov = _t(c["vis"][:256]), _t(c["ov"])
    before = dict(k1.launches)
    a = k1.intersect_brute_sweep(*tri, *rays, visibility=vis,
                                 object_visibility=ov)
    b = tisect.intersect_brute(*tri, *rays, visibility=vis,
                               object_visibility=ov)
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert torch.equal(
        k1.shadow_blocked_sweep(*tri, *rays, visibility=vis,
                                object_visibility=ov),
        tisect.shadow_blocked_brute(*tri, *rays, visibility=vis,
                                    object_visibility=ov))
    dual = (*tri, _t(c["bnd"]), *rays, _t(c["tmax_any"][:256]), vis,
            _t(c["vis_any"][:256]), ov)
    for x, y in zip(k1.occlusion_sweep(*dual),
                    tisect.intersect_brute_occlusion(*dual)):
        assert torch.equal(x, y)
    packets = [torch.zeros((2, 8, 3)) for _ in range(3)]
    packets[1][0, 0, 0] = packets[2][0, 0, 1] = 1.0
    m = k1.intersect_mt_sweep(*packets, *rays)
    assert all(torch.equal(m[k], v) for k, v in
               tisect.intersect_brute_mt(*packets, *rays).items())
    assert k1.launches == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    c = _case("cornell")
    tri, rays = _torch_args(c, 4)
    meta = tuple(torch.empty(x.shape, dtype=x.dtype, device="meta")
                 for x in rays)
    with pytest.raises(ValueError, match="CUDA tensor"):   # not CUDA tensors
        k1.intersect_brute_sweep(*tri, *meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.shadow_blocked_sweep(*tri, *meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.intersect_mt_sweep(*(torch.zeros((1, 8, 3)),) * 3, *meta)
    # deform motion is ported: on CPU tensors each mode takes its plain
    # version's deform sweep (the triangles moved by 5 along z at
    # shutter close, each ray at its own time), and launches nothing
    t1 = tri[0] + torch.tensor([0.0, 0.0, 5.0])
    time = torch.linspace(0.0, 1.0, rays[0].shape[0])
    before = dict(k1.launches)
    for fn, plain in ((k1.intersect_brute_sweep, tisect.intersect_brute),
                      (k1.shadow_blocked_sweep,
                       tisect.shadow_blocked_brute)):
        a = fn(*tri, *rays, tri_verts_t1=t1, time=time)
        b = plain(*tri, *rays, tri_verts_t1=t1, time=time)
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            assert torch.equal(x, y)
    vis4 = torch.full((rays[0].shape[0],), 1, dtype=torch.int32)
    dual = (*tri, _t(c["bnd"]), *rays, rays[3], vis4, vis4, _t(c["ov"]))
    for x, y in zip(k1.occlusion_sweep(*dual, tri_verts_t1=t1, time=time),
                    tisect.intersect_brute_occlusion(
                        *dual, tri_verts_t1=t1, time=time)):
        assert torch.equal(x, y)
    assert k1.launches == before
