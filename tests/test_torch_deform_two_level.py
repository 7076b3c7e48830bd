"""Two-level motion tables in the port, on glossy_deform_big
(raytracingproject_tpu_torch/app/examples.py): the glossy Cornell box
whose mirror sphere has 41,580 triangles and deforms on glossy_deform's
two-step path. Its host compile packs motion rows in two-level tables,
936 clusters x 64 triangles in 25 superclusters: K5 for every closest hit
and shadow test, K6 under GLOSSY_DEFORM_BIG_ONEHOT2.

This file holds:
- the host compile array-equal to the JAX package's (the JAX compile
  under tests/test_torch_deform_two_level_render.py's builder shim, R1),
  with equal statics, and the tables of the stated size;
- R7: the JAX package's CPU dispatch sends this scene to its packed BVH
  walk, whose leaves hold the shutter-open triangles, so at time 1 it
  returns its time-0 hits; its XLA motion walk over the same tables does
  not, and R7's route (sc_bounds dropped from its kg) reaches that walk.
  The port's dispatch (K5's plain version) is held to that walk;
- the dispatch: a 4x4 render sends K5 (K6 with the opt-in flag) the rays'
  times, and K6's capacity rule is the JAX package's packing rule;
- the wrappers of K5 and K6 on CPU tensors equal to their plain version
  with the lanes' times, launching nothing; motion with instance rows
  raising;
- the time-0 invariant: at time 0 the motion walk gives the static
  walk's answers on glossy_big's own (time-0) tables;
- the visit-order mirrors of K5 and K6 take the lanes' times: their
  outputs equal the plain walk's on rays whose hits move with the time.

The plain walk against the JAX package's K5 and K6 in interpret mode is
tests/test_torch_deform_two_level_{k5,k6}.py, the 16x16 render
tests/test_torch_deform_two_level_render.py.

Tolerances: as tests/test_torch_deform.py (compare_motion): XLA:CPU
contracts the multiply-add of the time lerp and of the shear, the port
never does, so hit masks and prims agree with the JAX package's on all
but DIFF_FRAC of the lanes, t within CONTRACTED_RTOL where both hit the
same prim, and the port's t, u, v equal the float32 numpy golden on the
lerped triangle bit for bit on every hit lane."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.ops import cluster_intersect as jci
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu.ops import pallas_onehot as jpo
from raytracingproject_tpu_torch.app import cli
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.models.scene import (
    KG_ARRAYS, KG_DEFORM, KG_DENSE, KG_OPTIONAL)
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import onehot2_walk as k6
from raytracingproject_tpu_torch.session.session import pixel_wavefront
from tests.test_torch_deform import DIFF_FRAC, compare_motion
from tests.test_torch_deform_two_level_render import (
    jax_scene, r7_kg, shimmed)

torch.set_num_threads(1)
W = 8
N = 128
STATICS = ("use_brute", "has_deform_motion", "deform_steps",
           "cluster_motion", "has_motion", "cluster_tris", "has_instances",
           "sc_gmax", "light_kinds", "lamp_types", "num_area_lamps",
           "background_shader", "volume_stack_depth")
CAMERA = np.float32([278.0, -800.0, 273.0])


@functools.lru_cache(maxsize=None)
def port_kg(static=False):
    ts = (tex.glossy_big_scene if static else tex.glossy_deform_big_scene)(
        W, W, 1)
    ts.device_update()
    return ts.make_kernel_globals("cpu")


@functools.lru_cache(maxsize=None)
def jax_kg():
    js = jax_scene(W, W, 1)
    with shimmed():
        js.device_update()
    return js.make_kernel_globals(device_put=False)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def rays(seed=21):
    """2N seeded rays at seeded times in [0, 1] (numpy): N from near the
    camera toward points around the mirror sphere at both shutter ends
    (most meet it, and where it is depends on the time), then N from
    inside the box in random directions (some leave by its open front).
    Keys o, d, tmin, tmax (1e30), vis (camera), time."""
    r = np.random.default_rng(seed)
    tgt = r.uniform([95.0, 80.0, 0.0], [355.0, 280.0, 230.0], (N, 3))
    o_a = CAMERA + r.uniform(-20.0, 20.0, (N, 3))
    d_a = tgt - o_a
    tv = port_kg()["dscene"]["tri_verts_world"].numpy().reshape(-1, 3)
    o_r = r.uniform(tv.min(0), tv.max(0), (N, 3))
    d_r = r.normal(size=(N, 3))
    d = np.concatenate([d_a, d_r])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = 2 * N
    return {"o": np.concatenate([o_a, o_r]).astype(np.float32),
            "d": d.astype(np.float32),
            "tmin": np.concatenate([np.zeros(N, np.float32),
                                    np.full(N, 1e-4, np.float32)]),
            "tmax": np.full(n, 1e30, np.float32),
            "vis": np.full(n, ob.PATH_RAY_CAMERA, np.int32),
            "time": r.uniform(0.0, 1.0, n).astype(np.float32)}


def lanes(r):
    return tuple(_t(r[k]) for k in ("o", "d", "tmin", "tmax", "vis"))


def two_level(kg):
    ds = kg["dscene"]
    return (ds["sc_bounds"], ds["cluster_bounds"], ds["cluster_table"],
            kg["cluster_tris"], kg["sc_gmax"])


def jax_lanes(r, time=None):
    out = [jnp.asarray(r[k]) for k in ("o", "d", "tmin", "tmax")]
    out.append(jnp.asarray(r["vis"].astype(np.uint32)))
    return out + ([] if time is None else [jnp.asarray(time)])


# ---- host compile ----------------------------------------------------


@pytest.mark.parametrize("name", KG_ARRAYS + KG_DENSE + KG_OPTIONAL
                         + KG_DEFORM)
def test_scene_arrays_equal(name):
    ref = np.asarray(jax_kg()["dscene"][name])
    got = port_kg()["dscene"][name].numpy()
    assert ref.shape == got.shape
    assert got.dtype == (np.int32 if ref.dtype == np.uint32 else ref.dtype)
    np.testing.assert_array_equal(ref, got)


def test_statics_and_table_sizes():
    jkg, tkg = jax_kg(), port_kg()
    assert jkg["kint"] == tkg["kint"]
    for k in STATICS:
        assert jkg[k] == tkg[k], k
    ds = tkg["dscene"]
    assert ds["tri_verts_world"].shape[0] == 42552
    assert tkg["cluster_motion"] and not tkg["use_brute"]
    assert tkg["cluster_tris"] == 64 and tkg["sc_gmax"] == 64
    assert ds["sc_bounds"].shape == (25, 8)
    assert ds["cluster_table"].shape == (936, tci.row_width(64, True))
    assert tci.row_width(64, True) == 1357
    # the sphere (41,580 triangles) moves; the rest of the box does not
    moved = (ds["tri_verts_world_t1"] != ds["tri_verts_world"]) \
        .flatten(1).any(1)
    assert int(moved.sum()) == 41580
    # the JAX package packs its K6 tables for it: the port's K6 takes it
    assert "oh2_hi" in jkg["dscene"]
    assert k6.fits(tkg["sc_gmax"], 25, 1357)


def test_cli_loads_the_configuration():
    for spec, flags in (("example:glossy_deform_big", {}),
                        ("example:glossy_deform_big:onehot2",
                         tex.GLOSSY_DEFORM_BIG_ONEHOT2)):
        scene, got = cli.load_scene(spec)
        assert got == flags
        assert (int(scene.camera.width), int(scene.camera.height)) \
            == (256, 256)
        assert int(scene.integrator.aa_samples) == 64
        assert int(scene.integrator.max_bounce) == 4


# ---- R7 and the reference route --------------------------------------


def test_r7_jax_cpu_dispatch_returns_time_zero_hits(monkeypatch):
    """At time 1 the JAX package's CPU dispatch returns its time-0 hits
    (the packed BVH walk). R7's route reaches its XLA motion walk over
    the same tables (intersect_clusters with has_motion, seen by a spy),
    whose hits at time 1 differ on most lanes (those toward either place
    of the sphere); the port's dispatch is held to that walk."""
    jkg, tkg = jax_kg(), port_kg()
    jkg = {**jkg, "dscene": {k: jnp.asarray(v)
                             for k, v in jkg["dscene"].items()}}
    r = dict(rays())
    one, zero = np.ones(2 * N, np.float32), np.zeros(2 * N, np.float32)
    seen = []
    walk = jci.intersect_clusters

    def spy(*a, **kw):
        seen.append((kw.get("has_motion"), kw.get("time") is not None))
        return walk(*a, **kw)
    monkeypatch.setattr(jci, "intersect_clusters", spy)

    def dispatch(kg):
        return jax.jit(lambda o, d, a, b, v, tm: jinteg._scene_intersect_tris(
            kg, o, d, a, b, v, time=tm))

    bvh = dispatch(jkg)
    at0, at1 = bvh(*jax_lanes(r, zero)), bvh(*jax_lanes(r, one))
    assert seen == []
    np.testing.assert_array_equal(np.asarray(at1["t"]), np.asarray(at0["t"]))
    np.testing.assert_array_equal(np.asarray(at1["prim"]),
                                  np.asarray(at0["prim"]))
    mw = {k: np.asarray(v)
          for k, v in dispatch(r7_kg(jkg))(*jax_lanes(r, one)).items()}
    assert seen == [(True, True)]
    # the first N rays are those toward the sphere
    assert (mw["t"] != np.asarray(at1["t"]))[:N].mean() > 0.6
    got = integ._scene_intersect_tris(tkg, *lanes(r), time=_t(one))
    r["time"] = one
    compare_motion(tkg, mw, {k: v.numpy() for k, v in got.items()}, r)


# ---- dispatch and K6's capacity ----------------------------------------


@pytest.mark.parametrize("flags,want", [
    ({}, "intersect_clusters2_walk"),
    (tex.GLOSSY_DEFORM_BIG_ONEHOT2, "intersect_clusters2_onehot")])
def test_dispatch_passes_the_rays_time(monkeypatch, flags, want):
    kg = {**port_kg(), **flags}
    calls = []
    for mod, fn in ((k5, "intersect_clusters2_walk"),
                    (k6, "intersect_clusters2_onehot")):
        orig = getattr(mod, fn)

        def wrapped(*a, _fn=fn, _orig=orig, **kw):
            calls.append((_fn, kw))
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, wrapped)
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    integ.render_samples_regen(kg, px, py, pidx, 0, 1)
    assert {fn for fn, _ in calls} == {want}
    assert any(kw["shadow_any_hit"] for _fn, kw in calls)
    for _fn, kw in calls:
        assert kw["has_motion"] is True and kw["time"].shape == (16,)


@pytest.mark.parametrize("sc,w", [(25, 1357), (25, 1408), (25, 1409),
                                  (40, 1357), (1, 13 + 21 * 128)])
def test_k6_capacity_is_the_jax_packing_rule(sc, w):
    """fits(gmax, sc, w) holds exactly where the JAX package packs its
    two-level one-hot tables (pack_onehot2_tables)."""
    scb = np.zeros((sc, 8), np.float32)
    scb[:, 7] = 1.0
    packed = jpo.pack_onehot2_tables(scb, np.zeros((1, 6), np.float32),
                                     np.zeros((1, w), np.float32), 64)
    assert k6.fits(64, sc, w) == (packed is not None)


# ---- the wrappers on CPU tensors --------------------------------------


@pytest.mark.parametrize("any_hit", [False, True])
def test_wrappers_take_the_plain_motion_walk_on_cpu(any_hit):
    kg, r = port_kg(), rays()
    tm = _t(r["time"])
    before = (k5.launches, k6.launches)
    ds, ct = kg["dscene"], kg["cluster_tris"]
    ref = tci.intersect_clusters(ds["cluster_bounds"], ds["cluster_table"],
                                 ct, *lanes(r), shadow_any_hit=any_hit,
                                 time=tm, has_motion=True)
    for fn in (k5.intersect_clusters2_walk, k6.intersect_clusters2_onehot):
        got = fn(*two_level(kg), *lanes(r), shadow_any_hit=any_hit,
                 has_motion=True, time=tm)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
        with pytest.raises(NotImplementedError, match="instance rows"):
            fn(*two_level(kg), *lanes(r), has_instances=True,
               has_motion=True, time=tm)
    assert (k5.launches, k6.launches) == before
    if not any_hit:   # the time changes the answer
        at0 = k5.intersect_clusters2_walk(*two_level(kg), *lanes(r),
                                          has_motion=True)
        assert not torch.equal(at0["t"], ref["t"])


def test_motion_walk_at_time_zero_is_the_static_walk():
    """The motion rows at time 0 are glossy_big's shutter-open triangles
    (same clusters; its static bounds are tighter): t, u, v equal, prim
    and object off exact-t ties, hit masks equal, closest and any hit."""
    kg, sk, r = port_kg(), port_kg(static=True), rays()
    ct = kg["cluster_tris"]
    assert sk["cluster_tris"] == ct and not sk["cluster_motion"]
    assert sk["dscene"]["cluster_table"].shape == (936, tci.row_width(ct))
    zero = torch.zeros(len(r["o"]))
    for any_hit in (False, True):
        x = k5.intersect_clusters2_walk(*two_level(kg), *lanes(r),
                                        shadow_any_hit=any_hit,
                                        has_motion=True, time=zero)
        y = k5.intersect_clusters2_walk(*two_level(sk), *lanes(r),
                                        shadow_any_hit=any_hit)
        assert torch.equal(x["prim"] >= 0, y["prim"] >= 0)
        if not any_hit:
            assert torch.equal(x["t"], y["t"])
            same = x["prim"] == y["prim"]
            assert same.float().mean() >= 1.0 - DIFF_FRAC
            for k in ("u", "v", "object"):
                assert torch.equal(x[k][same], y[k][same])


# ---- the visit-order mirrors take the lanes' times --------------------

MIRRORS = {"k5_scan": k5.cluster2_scan_order,
           "k5_queue": k5.cluster2_queue_order,
           "k6_scan": k6.onehot2_scan_order,
           "k6_queue": k6.onehot2_queue_order}


@pytest.mark.parametrize("any_hit", [False, True])
def test_mirrors_follow_the_lanes_time(any_hit):
    """Each mirror's outputs equal the plain walk's at the lanes' times
    (hit masks; t, u, v, object where the prims agree, which is all but
    DIFF_FRAC of the lanes), and each design's scan and queue mirrors
    equal each other on every lane. The rays are chosen so that the
    answer moves with the time: a mirror that dropped it would fail."""
    kg = port_kg()
    r = dict(rays())
    r.update({k: v[N - 64:N + 32] for k, v in r.items()})
    tm = _t(r["time"])
    ds, ct = kg["dscene"], kg["cluster_tris"]
    plain = tci.intersect_clusters(ds["cluster_bounds"], ds["cluster_table"],
                                   ct, *lanes(r), shadow_any_hit=any_hit,
                                   time=tm, has_motion=True)
    if not any_hit:
        at0 = tci.intersect_clusters(ds["cluster_bounds"],
                                     ds["cluster_table"], ct, *lanes(r),
                                     has_motion=True)
        assert (at0["t"] != plain["t"]).float().mean() > 0.3
    outs = {}
    for name, fn in MIRRORS.items():
        out = fn(*two_level(kg), *lanes(r), shadow_any_hit=any_hit,
                 time=tm, has_motion=True)[0]
        outs[name] = out
        assert torch.equal(out["prim"] >= 0, plain["prim"] >= 0), name
        if not any_hit:
            same = out["prim"] == plain["prim"]
            assert same.float().mean() >= 1.0 - DIFF_FRAC, name
            for k in ("t", "u", "v", "object"):
                assert torch.equal(out[k][same], plain[k][same]), (name, k)
    for a, b in (("k5_scan", "k5_queue"), ("k6_scan", "k6_queue")):
        assert all(torch.equal(outs[a][k], outs[b][k]) for k in plain)
