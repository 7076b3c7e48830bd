"""Deforming motion in the port, on its two scenes
(raytracingproject_tpu_torch/app/examples.py):

- glossy_deform: the glossy Cornell box (1,932 prims) whose mirror sphere
  moves on a two-step path; the host compile packs motion cluster rows,
  179 clusters x 15 triangles, 328 floats a row: K2 for the closest hit,
  K3 for the shadow test (K4 under examples.GLOSSY_DEFORM_TILE);
- cornell_deform: the Cornell box (36 prims) whose short box moves on a
  three-step path: deform_steps 3, no cluster tables, K1's deform modes.

The JAX twins are built from the JAX package's own calls
(tests/test_torch_deform_render.py jax_scene); every scene here has at
most 1,932 prims, so neither package's native builder runs.

This file holds:
- the host compile (the fault this slice settles: the port used to
  compile a deforming mesh as a static one) array-equal to the JAX
  package's, with tri_verts_world_t1, tri_verts_world_steps,
  cluster_bounds and the motion cluster_table, and equal statics;
  kg_from_jax on both scenes; object motion still raising;
- the dispatch: a 4x4 render sends each scene's walks and sweeps the
  rays' times;
- the plain dense sweeps with a two-step and a three-step path against
  the JAX package's intersect_brute, shadow_blocked_brute and
  intersect_brute_occlusion (a sliding quad, and 512 seeded rays at
  seeded times on cornell_deform's triangles), and the port's hits
  against the float32 numpy golden on the lerped triangle;
- the time-0 invariant: at time 0 every motion mode gives the static
  walk's (or sweep's) answers;
- the wrappers of K1, K2, K3 and K4 on CPU tensors equal to their plain
  versions, launching nothing; K4's visit-order mirrors on the motion
  table;
- K1's cull in its deform modes (block_keep with the steps): every hit of
  the plain sweep lies in a kept block, and the boxes of the static
  triangles alone would drop some.

The plain motion walks against the JAX package's K2, K4 and K3 in
interpret mode are tests/test_torch_deform_{k2,k4,k3}.py, the renders
tests/test_torch_deform_render.py.

Tolerances: XLA:CPU contracts the multiply-add of the time lerp (v +
time dv) and of the shear, the port never does; so hit masks and prims
agree with the JAX package's on all but DIFF_FRAC of the lanes, t within
CONTRACTED_RTOL where both hit, and the port's t, u, v equal the numpy
golden's bit for bit on every hit lane."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.ops import intersect as jisect
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.bvh.build import _wt_intersect_np
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.models.scene import (
    KG_ARRAYS, KG_DENSE, kg_from_jax)
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from raytracingproject_tpu_torch.ops import cluster_walk as k2
from raytracingproject_tpu_torch.ops import dense_sweep as k1
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import intersect as tisect
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
from raytracingproject_tpu_torch.ops import tile_walk as k4
from raytracingproject_tpu_torch.session.session import pixel_wavefront
from tests.test_torch_deform_render import PORT_SCENES, jax_scene

torch.set_num_threads(1)
W = 16
N = 256
MOTION = ("tri_verts_world_t1", "tri_verts_world_steps")
CLUSTER = ("cluster_bounds", "cluster_table", "cluster_boundary")
ARRAYS = [(s, k) for s in sorted(PORT_SCENES)
          for k in KG_ARRAYS + KG_DENSE + MOTION
          if s == "glossy" or k not in CLUSTER]
STATICS = ("use_brute", "has_deform_motion", "deform_steps",
           "cluster_motion", "has_motion", "cluster_tris", "has_instances",
           "sc_gmax", "light_kinds", "lamp_types", "num_area_lamps",
           "background_shader", "volume_stack_depth")
# XLA:CPU contraction: share of lanes whose hit or prim may differ, and
# how far t may move, relative
DIFF_FRAC = 0.01
CONTRACTED_RTOL = 2e-4


@functools.lru_cache(maxsize=None)
def port_kg(name):
    ts = PORT_SCENES[name](W, W, 1)
    ts.device_update()
    return ts.make_kernel_globals("cpu")


@functools.lru_cache(maxsize=None)
def jax_kg(name):
    js = jax_scene(name, W, W, 1)
    js.device_update()
    return js.make_kernel_globals(device_put=False)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def rays(name, seed=20):
    """N seeded random rays from inside the scene's box and the N
    pixel-centre camera rays of the 16x16 film, with seeded times in
    [0, 1]: numpy o, d, tmin, tmax (1e30), tmax_any (inside the scene on
    half the random lanes), vis (camera), time."""
    kg = port_kg(name)
    tv = kg["dscene"]["tri_verts_world"].numpy().reshape(-1, 3)
    r = np.random.default_rng(seed)
    o_r = r.uniform(tv.min(0), tv.max(0), (N, 3)).astype(np.float32)
    d_r = r.normal(size=(N, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:W, 0:W]
    rx = torch.tensor(xx.reshape(-1) + 0.5, dtype=torch.float32)
    ry = torch.tensor(yy.reshape(-1) + 0.5, dtype=torch.float32)
    z = torch.zeros_like(rx)
    cam = cam_ops.camera_sample_ray(kg["cam"], rx, ry, z, z, z)
    n = 2 * N
    tmax_any = np.full(n, 1e30, np.float32)
    tmax_any[:N] = np.where(r.uniform(size=N) < 0.5,
                            r.uniform(10.0, 400.0, N), 1e30)
    return {"o": np.concatenate([o_r, cam["o"].numpy()]),
            "d": np.concatenate([d_r, cam["d"].numpy()]),
            "tmin": np.concatenate([np.full(N, 1e-4, np.float32),
                                    np.zeros(N, np.float32)]),
            "tmax": np.full(n, 1e30, np.float32), "tmax_any": tmax_any,
            "vis": np.full(n, ob.PATH_RAY_CAMERA, np.int32),
            "time": r.uniform(0.0, 1.0, n).astype(np.float32)}


def lerped(tv, steps, tm):
    """float32 numpy corners of triangle tv (3, 3) at time tm on its path
    steps (S1, 3, 3), in the plain sweeps' operation order."""
    f = np.float32

    def vee(x):
        return np.stack([x[0], x[1] - x[0], x[2] - x[0]])

    cur = vee(tv)
    prev = cur
    s1 = len(steps)
    for k in range(s1):
        nxt = vee(steps[k])
        w = f(tm) if s1 == 1 else f(min(max(f(f(tm) * f(s1)) - f(k),
                                             f(0.0)), f(1.0)))
        cur = (cur + w * (nxt - prev)).astype(np.float32)
        prev = nxt
    return np.stack([cur[0], cur[0] + cur[1], cur[0] + cur[2]])


def port_walk(kg, r, any_hit=False):
    """The plain motion walk (K2's and K4's plain version) on the lanes
    of r at their times."""
    ds = kg["dscene"]
    out = tci.intersect_clusters(
        ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
        *_lanes(r, any_hit), shadow_any_hit=any_hit, time=_t(r["time"]),
        has_motion=True)
    return {k: v.numpy() for k, v in out.items()}


def compare_motion(kg, ref, got, r, any_hit=False):
    """The port's walk against the JAX package's: hit masks and prims
    equal on all but DIFF_FRAC of the lanes (for any hit the masks are
    all the contract fixes), t within CONTRACTED_RTOL where both hit the
    same prim, and the port's t, u, v the numpy golden's on the lerped
    triangle, bit for bit, on every hit lane."""
    hit = got["prim"] >= 0
    assert 0.2 < hit.mean() < 0.99
    assert ((ref["prim"] >= 0) != hit).mean() <= DIFF_FRAC
    if any_hit:
        return
    assert (ref["prim"] != got["prim"]).mean() <= DIFF_FRAC
    both = hit & (ref["prim"] == got["prim"])
    np.testing.assert_allclose(got["t"][both], ref["t"][both],
                               rtol=CONTRACTED_RTOL)
    ds = kg["dscene"]
    tv = ds["tri_verts_world"].numpy()
    t1 = ds["tri_verts_world_t1"].numpy()
    for i in np.nonzero(hit)[0]:
        p = got["prim"][i]
        tri = lerped(tv[p], t1[p][None], r["time"][i])
        gold = _wt_intersect_np(tri, r["o"][i], r["d"][i])
        assert (got["t"][i], got["u"][i], got["v"][i]) == gold, i


# ---- host compile ----------------------------------------------------


@pytest.mark.parametrize("scene,name", ARRAYS)
def test_scene_arrays_equal(scene, name):
    ref = np.asarray(jax_kg(scene)["dscene"][name])
    got = port_kg(scene)["dscene"][name].numpy()
    assert ref.shape == got.shape
    assert got.dtype == (np.int32 if ref.dtype == np.uint32 else ref.dtype)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("scene", sorted(PORT_SCENES))
def test_statics_equal(scene):
    jkg, tkg = jax_kg(scene), port_kg(scene)
    assert jkg["kint"] == tkg["kint"]
    for k in STATICS:
        assert jkg[k] == tkg[k], k


@pytest.mark.parametrize("scene", sorted(PORT_SCENES))
def test_deforming_mesh_compiles_as_deforming(scene):
    """The port's compile used to drop std_motion_vertex_position: the
    scenes compiled static, with no shutter-close triangles."""
    kg = port_kg(scene)
    ds = kg["dscene"]
    assert kg["has_deform_motion"] and kg["has_motion"]
    tv, t1 = ds["tri_verts_world"], ds["tri_verts_world_t1"]
    moved = (t1 != tv).flatten(1).any(1)
    if scene == "glossy":
        assert kg["deform_steps"] == 2 and kg["cluster_motion"]
        assert not kg["use_brute"] and int(moved.sum()) == 960   # sphere1
        assert ds["cluster_table"].shape == (179, tci.row_width(15, True))
        assert tci.row_width(15, True) == 328
    else:
        assert kg["deform_steps"] == 3 and not kg["cluster_motion"]
        assert kg["use_brute"] and "cluster_bounds" not in ds
        assert ds["tri_verts_world_steps"].shape == (2, 36, 3, 3)
        assert int(moved.sum()) == 12                            # short box


@pytest.mark.parametrize("scene", sorted(PORT_SCENES))
def test_kg_from_jax_carries_the_scene(scene):
    tkg = port_kg(scene)
    ckg = kg_from_jax(jax_kg(scene), "cpu")
    for k in tkg["dscene"]:
        assert torch.equal(ckg["dscene"][k], tkg["dscene"][k]), k
    for k in STATICS:
        assert ckg[k] == tkg[k], k
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    a = integ.render_samples_regen(ckg, px, py, pidx, 0, 1)[0]
    b = integ.render_samples_regen(tkg, px, py, pidx, 0, 1)[0]
    assert torch.equal(a, b)


def test_object_motion_still_raises():
    scene = tex.cornell_box(4, 4, 1)
    scene.objects[0].set("use_motion", True)
    with pytest.raises(NotImplementedError, match="object motion"):
        scene.device_update()
    with pytest.raises(NotImplementedError, match="object motion"):
        kg_from_jax({**jax_kg("cornell"), "has_motion": True,
                     "has_deform_motion": False}, "cpu")


# ---- dispatch --------------------------------------------------------


@pytest.mark.parametrize("scene,flags,want", [
    ("glossy", {}, {"intersect_clusters_walk", "occlusion_clusters_walk"}),
    ("glossy", tex.GLOSSY_DEFORM_TILE,
     {"intersect_clusters_tile", "occlusion_clusters_walk"}),
    ("cornell", {}, {"intersect_brute_sweep", "shadow_blocked_sweep"})])
def test_dispatch_passes_the_rays_time(monkeypatch, scene, flags, want):
    kg = {**port_kg(scene), **flags}
    calls = []

    def spy(mod, fn):
        orig = getattr(mod, fn)

        def wrapped(*a, **kw):
            calls.append((fn, kw))
            return orig(*a, **kw)
        monkeypatch.setattr(mod, fn, wrapped)

    for mod, fn in ((k2, "intersect_clusters_walk"),
                    (k4, "intersect_clusters_tile"),
                    (k3, "occlusion_clusters_walk"),
                    (k1, "intersect_brute_sweep"),
                    (k1, "shadow_blocked_sweep")):
        spy(mod, fn)
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    integ.render_samples_regen(kg, px, py, pidx, 0, 1)
    assert {fn for fn, _ in calls} == want
    for _fn, kw in calls:
        assert kw["time"].shape == (16,)
        if scene == "glossy":
            assert kw["has_motion"] is True
        else:
            assert kw["tri_verts_t1"].shape == (2, 36, 3, 3)


# ---- the plain dense sweeps against the JAX package -----------------

QUAD = np.array([[[-1, -1, 0], [1, -1, 0], [1, 1, 0]],
                 [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]], np.float32)
PATHS = {"two_step": (QUAD + np.float32([10, 0, 0]))[None],
         "three_step": np.stack([QUAD + np.float32([0, 4, 0]),
                                 QUAD + np.float32([10, 4, 0])])}


def _where_at(path, tm):
    """x, y of the quad's centre at time tm (piecewise linear)."""
    pts = np.concatenate([QUAD[None], path]).mean((1, 2))
    s = tm * (len(pts) - 1)
    k = np.minimum(np.floor(s).astype(int), len(pts) - 2)
    f = (s - k)[:, None]
    return (1 - f) * pts[k] + f * pts[k + 1]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sliding_quad_is_met_at_the_rays_time(path):
    """Rays aimed where the quad is at their own time hit it, in both
    packages; rays aimed at its shutter-open place miss it at time 1."""
    steps = PATHS[path]
    n = 9
    tm = np.linspace(0.0, 1.0, n).astype(np.float32)
    xy = _where_at(steps, tm)
    o = np.concatenate([xy[:, :2], np.full((n, 1), 5.0)], 1) \
        .astype(np.float32)
    d = np.tile(np.float32([0, 0, -1]), (n, 1))
    po = np.zeros(2, np.int32)
    tmin, tmax = np.zeros(n, np.float32), np.full(n, 100.0, np.float32)
    got = tisect.intersect_brute(_t(QUAD), _t(po), _t(o), _t(d), _t(tmin),
                                 _t(tmax), tri_verts_t1=_t(steps),
                                 time=_t(tm))
    ref = jisect.intersect_brute(
        jnp.asarray(QUAD), jnp.asarray(po), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), tri_verts_t1=jnp.asarray(steps),
        time=jnp.asarray(tm))
    assert (got["prim"].numpy() >= 0).all()
    np.testing.assert_array_equal(got["prim"].numpy(),
                                  np.asarray(ref["prim"]))
    np.testing.assert_allclose(got["t"].numpy(), 5.0, atol=1e-4)
    o0 = np.tile(np.float32([0, 0, 5]), (n, 1))
    one = np.ones(n, np.float32)
    assert not tisect.shadow_blocked_brute(
        _t(QUAD), _t(po), _t(o0), _t(d), _t(tmin), _t(tmax),
        tri_verts_t1=_t(steps), time=_t(one)).any()
    assert not np.asarray(jisect.shadow_blocked_brute(
        jnp.asarray(QUAD), jnp.asarray(po), jnp.asarray(o0), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), tri_verts_t1=jnp.asarray(steps),
        time=jnp.asarray(one))).any()


def _dense_args(steps_kind):
    kg = port_kg("cornell")
    ds = kg["dscene"]
    steps = ds["tri_verts_world_steps"].numpy()
    if steps_kind == "two_step":
        steps = steps[-1:]
    r = rays("cornell")
    return kg, ds["tri_verts_world"].numpy(), \
        ds["prim_object_packed"].numpy(), steps, r


@pytest.mark.parametrize("steps_kind", ["two_step", "three_step"])
def test_plain_dense_sweeps_vs_jax(steps_kind):
    kg, tv, po, steps, r = _dense_args(steps_kind)
    ov = kg["dscene"]["object_visibility"].numpy()
    bnd = np.arange(len(tv)) % 3 == 0
    tmax_any = r["tmax_any"]
    shadow = np.full(len(r["o"]), ob.PATH_RAY_SHADOW, np.int32)
    T = {k: _t(v) for k, v in (("tv", tv), ("po", po), ("steps", steps),
                               ("ov", ov), ("bnd", bnd), ("sh", shadow))}
    J = {k: jnp.asarray(v) for k, v in (
        ("tv", tv), ("po", po), ("steps", steps), ("ov", ov.astype(np.uint32)),
        ("bnd", bnd), ("sh", shadow.astype(np.uint32)))}
    tr = {k: _t(v) for k, v in r.items()}
    jr = {k: jnp.asarray(v) for k, v in r.items()}
    got = tisect.intersect_brute(T["tv"], T["po"], tr["o"], tr["d"],
                                 tr["tmin"], tr["tmax"], tr["vis"], T["ov"],
                                 tri_verts_t1=T["steps"], time=tr["time"])
    ref = jisect.intersect_brute(
        J["tv"], J["po"], jr["o"], jr["d"], jr["tmin"], jr["tmax"],
        visibility=jr["vis"].astype(jnp.uint32), object_visibility=J["ov"],
        tri_verts_t1=J["steps"], time=jr["time"])
    g = {k: v.numpy() for k, v in got.items()}
    f = {k: np.asarray(v) for k, v in ref.items()}
    hit = g["prim"] >= 0
    assert 0.5 < hit.mean() < 0.99
    assert ((f["prim"] >= 0) != hit).mean() <= DIFF_FRAC
    assert (f["prim"] != g["prim"]).mean() <= DIFF_FRAC
    both = hit & (f["prim"] == g["prim"])
    np.testing.assert_allclose(g["t"][both], f["t"][both],
                               rtol=CONTRACTED_RTOL)
    for i in np.nonzero(hit)[0]:
        p = g["prim"][i]
        tri = lerped(tv[p], steps[:, p], r["time"][i])
        gold = _wt_intersect_np(tri, r["o"][i], r["d"][i])
        assert (g["t"][i], g["u"][i], g["v"][i]) == gold, i
    blk = tisect.shadow_blocked_brute(
        T["tv"], T["po"], tr["o"], tr["d"], tr["tmin"], tr["tmax_any"],
        T["sh"], T["ov"], tri_verts_t1=T["steps"], time=tr["time"]).numpy()
    jblk = np.asarray(jisect.shadow_blocked_brute(
        J["tv"], J["po"], jr["o"], jr["d"], jr["tmin"], jr["tmax_any"],
        visibility=J["sh"], object_visibility=J["ov"],
        tri_verts_t1=J["steps"], time=jr["time"]))
    assert 0.2 < blk.mean() < 0.99 and (blk != jblk).mean() <= DIFF_FRAC
    cam = np.full(len(r["o"]), ob.PATH_RAY_CAMERA, np.int32)
    tb, to, ob_ = (x.numpy() for x in tisect.intersect_brute_occlusion(
        T["tv"], T["po"], T["bnd"], tr["o"], tr["d"], tr["tmin"],
        _t(tmax_any), tr["tmax_any"], _t(cam), T["sh"], T["ov"],
        tri_verts_t1=T["steps"], time=tr["time"]))
    jtb, jto, job = (np.asarray(x) for x in jisect.intersect_brute_occlusion(
        J["tv"], J["po"], J["bnd"], jr["o"], jr["d"], jr["tmin"],
        tmax_closest=jr["tmax_any"], tmax_any=jr["tmax_any"],
        visibility_closest=jnp.asarray(cam.astype(np.uint32)),
        visibility_any=J["sh"], object_visibility=J["ov"],
        tri_verts_t1=J["steps"], time=jr["time"]))
    assert (ob_ != job).mean() <= DIFF_FRAC
    np.testing.assert_allclose(tb, jtb, rtol=CONTRACTED_RTOL)
    np.testing.assert_allclose(to, jto, rtol=CONTRACTED_RTOL)


# ---- the time-0 invariant --------------------------------------------


@pytest.mark.parametrize("steps_kind", ["two_step", "three_step"])
def test_dense_sweeps_at_time_zero_are_the_static_sweeps(steps_kind):
    kg, tv, po, steps, r = _dense_args(steps_kind)
    a = (_t(tv), _t(po), _t(r["o"]), _t(r["d"]), _t(r["tmin"]),
         _t(r["tmax_any"]))
    zero = {"tri_verts_t1": _t(steps), "time": torch.zeros(len(r["o"]))}
    x, y = tisect.intersect_brute(*a, **zero), tisect.intersect_brute(*a)
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert torch.equal(tisect.shadow_blocked_brute(*a, **zero),
                       tisect.shadow_blocked_brute(*a))
    # the wrappers on CPU tensors, every mode
    before = dict(k1.launches)
    x = k1.intersect_brute_sweep(*a, **zero)
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert k1.launches == before


@functools.lru_cache(maxsize=None)
def static_kg():
    ts = tex.cornell_box(W, W, 1, spheres="glossy")
    ts.device_update()
    return ts.make_kernel_globals("cpu")


def _lanes(r, any_hit=False):
    return (_t(r["o"]), _t(r["d"]), _t(r["tmin"]),
            _t(r["tmax_any"] if any_hit else r["tmax"]), _t(r["vis"]))


def test_motion_walks_at_time_zero_are_the_static_walks():
    """The motion table's rows at time 0 are its shutter-open triangles:
    the glossy box's own table (same clusters, static bounds). K2's, K4's
    and K3's modes through their wrappers on CPU tensors: t, u, v equal,
    prim and object off exact-t ties; K3's minima and any hit equal."""
    kg, sk, r = port_kg("glossy"), static_kg(), rays("glossy")
    ds, ss = kg["dscene"], sk["dscene"]
    ct = kg["cluster_tris"]
    assert sk["cluster_tris"] == ct
    assert ss["cluster_table"].shape[0] == ds["cluster_table"].shape[0]
    zero = torch.zeros(len(r["o"]))
    for fn in (k2.intersect_clusters_walk, k4.intersect_clusters_tile):
        for any_hit in (False, True):
            x = fn(ds["cluster_bounds"], ds["cluster_table"], ct,
                   *_lanes(r, any_hit), shadow_any_hit=any_hit,
                   has_motion=True, time=zero)
            y = fn(ss["cluster_bounds"], ss["cluster_table"], ct,
                   *_lanes(r, any_hit), shadow_any_hit=any_hit)
            assert torch.equal(x["prim"] >= 0, y["prim"] >= 0)
            if not any_hit:
                assert torch.equal(x["t"], y["t"])
                same = x["prim"] == y["prim"]
                assert same.float().mean() >= 1.0 - DIFF_FRAC
                for k in ("u", "v", "object"):
                    assert torch.equal(x[k][same], y[k][same])
    o, d, tmin, _tmax, _vis = _lanes(r)
    tmc = _t(np.where(np.arange(len(r["o"])) % 2 == 0, r["tmin"],
                      r["tmax_any"]))
    x = k3.occlusion_clusters_walk(
        ds["cluster_bounds"], ds["cluster_table"], ds["cluster_boundary"],
        ct, o, d, tmin, tmc, _t(r["tmax_any"]), ob.PATH_RAY_CAMERA,
        ob.PATH_RAY_SHADOW, has_motion=True)   # time None: zeros
    y = k3.occlusion_clusters_walk(
        ss["cluster_bounds"], ss["cluster_table"], ss["cluster_boundary"],
        ct, o, d, tmin, tmc, _t(r["tmax_any"]), ob.PATH_RAY_CAMERA,
        ob.PATH_RAY_SHADOW)
    assert all(torch.equal(p, q) for p, q in zip(x, y))


# ---- the wrappers on CPU tensors and K4's mirrors --------------------


def test_wrappers_take_the_plain_motion_walks_on_cpu():
    kg, r = port_kg("glossy"), rays("glossy")
    ds, ct = kg["dscene"], kg["cluster_tris"]
    tm = _t(r["time"])
    before = (k2.launches, k3.launches, k4.launches)
    args = (ds["cluster_bounds"], ds["cluster_table"], ct, *_lanes(r))
    ref = tci.intersect_clusters(*args, time=tm, has_motion=True)
    for fn in (k2.intersect_clusters_walk, k4.intersect_clusters_tile):
        got = fn(*args, has_motion=True, time=tm)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    # the time changes the answer
    at0 = tci.intersect_clusters(*args, has_motion=True)
    assert not torch.equal(at0["t"], ref["t"])
    o, d, tmin, _tmax, _vis = _lanes(r)
    occ = (ds["cluster_bounds"], ds["cluster_table"], ds["cluster_boundary"],
           ct, o, d, tmin, _t(r["tmax_any"]), _t(r["tmax_any"]),
           ob.PATH_RAY_CAMERA, ob.PATH_RAY_SHADOW)
    x = k3.occlusion_clusters_walk(*occ, has_motion=True, time=tm)
    y = tci.occlusion_clusters(*occ, has_motion=True, time=tm)
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert (k2.launches, k3.launches, k4.launches) == before


@pytest.mark.parametrize("any_hit", [False, True])
def test_k4_mirrors_on_the_motion_table(any_hit):
    """tile_scan_order and tile_queue_order take the lanes' times: their
    outputs equal each other on every lane, and the plain walk's hit
    masks (and t, u, v, prim, object off exact-t ties)."""
    kg, r = port_kg("glossy"), rays("glossy")
    ds, ct = kg["dscene"], kg["cluster_tris"]
    args = (ds["cluster_bounds"], ds["cluster_table"], ct,
            *_lanes(r, any_hit))
    kw = {"shadow_any_hit": any_hit, "time": _t(r["time"]),
          "has_motion": True}
    scan, _ = k4.tile_scan_order(*args, **kw)
    queue, _ = k4.tile_queue_order(*args, **kw)
    plain = tci.intersect_clusters(*args, **kw)
    assert all(torch.equal(scan[k], queue[k]) for k in scan)
    assert torch.equal(scan["prim"] >= 0, plain["prim"] >= 0)
    if not any_hit:
        same = scan["prim"] == plain["prim"]
        assert same.float().mean() >= 1.0 - DIFF_FRAC
        for k in ("t", "u", "v", "object"):
            assert torch.equal(scan[k][same], plain[k][same])


# ---- K1's cull in its deform modes ------------------------------------


def _quad_rays(path, n=512, seed=22):
    """n rays toward points of the sliding quad where it is at their
    seeded times, from 5 above it, a few degrees off the vertical."""
    r = np.random.default_rng(seed)
    tm = r.uniform(0.0, 1.0, n).astype(np.float32)
    p = np.concatenate([_where_at(PATHS[path], tm)[:, :2]
                        + r.uniform(-0.8, 0.8, (n, 2)),
                        np.zeros((n, 1))], 1)
    d = np.concatenate([r.normal(0.0, 0.05, (n, 2)), -np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = p - 5.0 * d
    return (_t(o.astype(np.float32)), _t(d.astype(np.float32)),
            torch.full((n,), 1e-4), _t(tm))


@pytest.mark.parametrize("scene", ["cornell", "quad"])
@pytest.mark.parametrize("steps_kind", ["two_step", "three_step"])
def test_block_keep_holds_every_hit_of_the_moving_triangles(steps_kind,
                                                            scene):
    """cornell: cornell_deform's triangles, the grazing set and 512
    seeded rays; quad: the sliding quad (one block, moving five times its
    extent), rays aimed where it is at their times, where the shutter-open
    boxes (even the wide one) miss most hits."""
    if scene == "cornell":
        kg, tv, po, steps, r = _dense_args(steps_kind)
        tvt, st = _t(tv), _t(steps)
        o, d, tmin = k1.grazing_rays(tvt, 1200, 21)
        n = o.shape[0]
        o = torch.cat([o, _t(r["o"])])
        d = torch.cat([d, _t(r["d"])])
        tmin = torch.cat([tmin, _t(r["tmin"])])
        tm = torch.cat([torch.linspace(0.0, 1.0, n), _t(r["time"])])
    else:
        tvt, st, po = _t(QUAD), _t(PATHS[steps_kind]), np.zeros(2, np.int32)
        o, d, tmin, tm = _quad_rays(steps_kind)
    ws = tisect.watertight_setup(o[:, None], d[:, None])
    valid, t, _u, _v = tisect.wt_block(
        ws, *tisect.tris_at(tvt, _t(po), st, tm), tmin[:, None], 1e30)
    lane, tri = valid.nonzero(as_tuple=True)
    assert lane.numel() > 400
    gate = torch.full((o.shape[0],), 1e30)
    keep = k1.block_keep(tvt, o, d, tmin, gate, st)
    assert keep[lane, tri // 8].all()
    # the shutter-open boxes alone drop hits of the moved triangles
    static = k1.block_keep(tvt, o, d, tmin, gate)
    assert not static[lane, tri // 8].all()
    # the counts' mirror runs the same predicate with the mode's gates
    a = {"tri_verts": tvt, "prim_object": _t(po), "o": o, "d": d,
         "tmin": tmin, "tmax": gate, "visibility": None,
         "object_visibility": None, "tri_verts_t1": st, "time": tm}
    kept, tested = k1.kept_blocks("closest", a)
    hit = tisect.intersect_brute(tvt, _t(po), o, d, tmin, gate,
                                 tri_verts_t1=st, time=tm)
    h = hit["prim"] >= 0
    assert kept[h.nonzero()[:, 0], (hit["prim"][h] // 8).long()].all()
    assert (tested[h] > 0).all()
