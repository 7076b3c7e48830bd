"""Instance rows in the single-level cluster walks (K2, K3, K4, K7), on the
two instanced scenes whose tables stay single-level:

- instanced_scene(grid=6): 36 x 528 + 2 = 19,010 flat prims, over
  AUTO_FLATTEN_MAX_PRIMS (16,384), so the sphere stays instanced: 530
  packed prims, 577 clusters x 38 triangles with instance rows, no
  superclusters; the closest hit goes to K4 (577 > K2's 512), the shadow
  test to K3;
- instanced_scene(grid=5, nlat=15): 25 x 672 + 2 = 16,802 flat prims, 674
  packed, 401 clusters x 48: K2 and K3, and in fused-NEE mode K7.

Every BVH of both scenes is a NumPy build (at most 674 prims), in both
packages: nothing here reaches the JAX package's native builder.

This file holds:
- the port's host compile of both scenes at 16x16 against the JAX
  package's make_kernel_globals: array-equal tables (cluster_table with
  its w2o columns, cluster_bounds, cluster_boundary, the object, instance
  and light arrays), equal statics, and kg_from_jax converting both;
- the dispatch: grid=6 sends its closest hits to K4 and its shadow tests
  to K3, grid=5 / nlat=15 to K2 and K3 (K7 in fused-NEE mode), every call
  with has_instances; motion rows still raise with instance rows in K2,
  K3 and K4, and alone in K5, K6 and K7;
- on CPU tensors the four wrappers return their plain versions' results
  with instance rows and launch nothing;
- K4's visit-order mirrors (ops/tile_walk.py tile_scan_order and
  tile_queue_order) with instance rows on grid=6's table, against the
  plain walk;
- the plain occlusion walk with instance rows (ops/cluster_intersect.py
  occlusion_clusters, K3's plain version) against the JAX package's K3
  (occlusion_clusters_pallas in interpret mode) on grid=6's table, both
  forms in one call: even lanes the surface form (an empty closest
  window), odd lanes the dual form, with seeded boundary flags.

The rays (`rays`): 256 seeded random rays from inside the scene's cluster
boxes, the 256 pixel-centre camera rays of the 16x16 film and 256 sun
shadow rays from seeded points on the ground; the any-hit windows end
inside the scene on half the random lanes.

The K4, K2 and K7 comparisons with the JAX package are in
tests/test_torch_instanced_single_{k4,k2,k2_any,k7}.py and the renders
in tests/test_torch_instanced_single_render{6,5}.py, each file apart so
that each stays well inside a minute on its own. They share the helpers
below. Closest hits are held as tests/test_torch_cluster2.py holds K5's:
hit masks equal, prim and object equal outside exact-t ties, and t, u, v
equal the JAX package's bit for bit or, where XLA:CPU contracts a
multiply-add in the transform or the shear, the float32 numpy golden
(bvh/build.py _wt_intersect_np on the ray transformed by the row's w2o)
bit for bit."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import pallas_cluster as pcl
from raytracingproject_tpu_torch.app import cli
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.bvh.build import _wt_intersect_np
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.models.scene import (
    KG_ARRAYS, KG_DENSE, kg_from_jax)
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from raytracingproject_tpu_torch.ops import cluster_walk as k2
from raytracingproject_tpu_torch.ops import dual_walk as k7
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import occlusion_walk as k3
from raytracingproject_tpu_torch.ops import onehot2_walk as k6
from raytracingproject_tpu_torch.ops import tile_walk as k4
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
W = 16
SPP = 4
SCENES = {"grid6": {"grid": 6}, "grid5_nlat15": {"grid": 5, "nlat": 15}}
# per scene: packed prims, clusters, triangles a cluster, closest-hit walk
TABLES = {"grid6": (530, 577, 38, "tile_walk"),
          "grid5_nlat15": (674, 401, 48, "cluster_walk")}
STATICS = ("sc_gmax", "cluster_tris", "has_instances", "use_brute",
           "light_kinds", "lamp_types", "num_area_lamps",
           "background_shader", "volume_stack_depth")
N = 256                        # lanes of each ray set
SUN = np.array([0.3, -0.4, 0.85], np.float32)   # toward the distant sun
SUN = SUN / np.linalg.norm(SUN)


@functools.lru_cache(maxsize=None)
def port_kg(name):
    ts = tex.instanced_scene(W, W, spp=SPP, **SCENES[name])
    ts.device_update()
    return ts.make_kernel_globals("cpu")


@functools.lru_cache(maxsize=None)
def jax_kg(name):
    js = jex.instanced_scene(W, W, spp=SPP, **SCENES[name])
    js.device_update()
    return js.make_kernel_globals(device_put=False)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def rays(name):
    """The 768 lanes: random, camera, sun shadow (N each). Returns numpy
    o, d, tmin, tmax (1e30 everywhere: the closest-hit window), tmax_any
    (the any-hit window) and vis (camera visibility)."""
    kg = port_kg(name)
    cb = kg["dscene"]["cluster_bounds"].numpy()
    r = np.random.default_rng(19)
    o_r = r.uniform(cb[:, :3].min(0), cb[:, 3:].max(0),
                    (N, 3)).astype(np.float32)
    d_r = r.normal(size=(N, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:W, 0:W]
    rx = torch.tensor(xx.reshape(-1) + 0.5, dtype=torch.float32)
    ry = torch.tensor(yy.reshape(-1) + 0.5, dtype=torch.float32)
    z = torch.zeros_like(rx)
    cam = cam_ops.camera_sample_ray(kg["cam"], rx, ry, z, z, z)
    o_s = np.concatenate([r.uniform(-14.0, 14.0, (N, 2)),
                          np.full((N, 1), 1e-3)], 1).astype(np.float32)
    o = np.concatenate([o_r, cam["o"].numpy(), o_s])
    d = np.concatenate([d_r, cam["d"].numpy(), np.tile(SUN, (N, 1))])
    n = 3 * N
    tmin = np.concatenate([np.full(N, 1e-4, np.float32),
                           np.zeros(N, np.float32),
                           np.full(N, 1e-4, np.float32)])
    tmax_any = np.full(n, 1e30, np.float32)
    tmax_any[:N] = np.where(r.uniform(size=N) < 0.5,
                            r.uniform(1.0, 40.0, N), 1e30)
    return {"o": o, "d": d, "tmin": tmin,
            "tmax": np.full(n, 1e30, np.float32), "tmax_any": tmax_any,
            "vis": np.full(n, ob.PATH_RAY_CAMERA, np.int32)}


def golden(ctab, ct, prim, obj, o, d):
    """float32 numpy (t, u, v) of the hit (prim, object): the row holding
    it, the ray transformed by the row's w2o (m[0]*ox + m[1]*oy + m[2]*oz
    + m[3], left to right), the triangle rebuilt as v0, v0 + e1, v0 +
    e2."""
    pb = tci.META_COLS + 9 * ct
    rows, slots = np.nonzero((ctab[:, pb:pb + ct] == prim)
                             & (ctab[:, pb + ct:pb + 2 * ct] == obj))
    assert len(rows) == 1
    row, k = ctab[rows[0]], slots[0]
    m = row[:12]
    f = np.float32
    oo = np.array([f(f(f(m[4 * r] * o[0]) + f(m[4 * r + 1] * o[1]))
                     + f(m[4 * r + 2] * o[2])) + m[4 * r + 3]
                   for r in range(3)], np.float32)
    dd = np.array([f(f(m[4 * r] * d[0]) + f(m[4 * r + 1] * d[1]))
                   + f(m[4 * r + 2] * d[2]) for r in range(3)], np.float32)
    tri = row[tci.META_COLS + 9 * k:tci.META_COLS + 9 * k + 9].reshape(3, 3)
    tri = np.stack([tri[0], tri[0] + tri[1], tri[0] + tri[2]])
    return _wt_intersect_np(tri, oo, dd)


# how far XLA:CPU's contraction of a multiply-add (in the transform or
# the shear) may move the JAX package's t, relative; each lane where the
# two differ is held to the numpy golden bit for bit
CONTRACTED_RTOL = 2e-4
# share of lanes whose hit lies at an exact-t tie between two prims
TIE_FRAC = 0.01


def compare_closest(kg, ref, got, r, any_hit=False):
    """Hit masks equal (for any hit, that is all the contract fixes);
    prim and object equal outside exact-t ties; t, u, v equal the
    reference's bit for bit or, t within CONTRACTED_RTOL of it, the numpy
    golden's."""
    np.testing.assert_array_equal(ref["prim"] >= 0, got["prim"] >= 0)
    hit = got["prim"] >= 0
    assert 0.2 < hit.mean() < 0.95
    if any_hit:
        return
    np.testing.assert_array_equal(got["t"][~hit], ref["t"][~hit])
    tie = hit & ((got["prim"] != ref["prim"])
                 | (got["object"] != ref["object"]))
    np.testing.assert_array_equal(got["t"][tie], ref["t"][tie])
    assert tie.mean() <= TIE_FRAC
    same = (got["t"] == ref["t"]) & (got["u"] == ref["u"]) \
        & (got["v"] == ref["v"])
    off = hit & ~tie & ~same
    np.testing.assert_allclose(got["t"][off], ref["t"][off],
                               rtol=CONTRACTED_RTOL)
    ctab = kg["dscene"]["cluster_table"].numpy()
    ct = int(kg["cluster_tris"])
    for i in np.nonzero(off)[0]:
        gold = golden(ctab, ct, got["prim"][i], got["object"][i], r["o"][i],
                      r["d"][i])
        assert (got["t"][i], got["u"][i], got["v"][i]) == gold, i


def port_closest(kg, r, any_hit=False):
    """The plain walk with instance rows (K2's and K4's plain version)."""
    ds = kg["dscene"]
    out = tci.intersect_clusters(
        ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
        _t(r["o"]), _t(r["d"]), _t(r["tmin"]),
        _t(r["tmax_any"] if any_hit else r["tmax"]), _t(r["vis"]),
        shadow_any_hit=any_hit, has_instances=True)
    return {k: v.numpy() for k, v in out.items()}


# ---- host compile ----------------------------------------------------


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("name", KG_ARRAYS + KG_DENSE)
def test_scene_arrays_equal(scene, name):
    ref = np.asarray(jax_kg(scene)["dscene"][name])
    got = port_kg(scene)["dscene"][name].numpy()
    assert ref.shape == got.shape
    # uint32 bit masks are int32 on the torch side
    assert got.dtype == (np.int32 if ref.dtype == np.uint32 else ref.dtype)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_statics_equal(scene):
    jkg, tkg = jax_kg(scene), port_kg(scene)
    assert jkg["kint"] == tkg["kint"]
    for k in STATICS:
        assert jkg[k] == tkg[k], k
    for k, v in jkg["cam"].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(tkg["cam"][k]), err_msg=k)
    assert [s.name for s in jkg["shaders"]] == [s.name for s in tkg["shaders"]]
    on = {k for k, v in jkg["features"].items() if v is True}
    assert on == {k for k, v in tkg["features"].items() if v}
    np.testing.assert_array_equal(np.asarray(jkg["textures"].data),
                                  tkg["textures"].data.numpy())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kg_from_jax_carries_the_scene(scene):
    """kg_from_jax turns the JAX package's arrays into the port's: every
    array the port reads, equal, and the same image at 4x4x2."""
    tkg = port_kg(scene)
    ckg = kg_from_jax(jax_kg(scene), "cpu")
    for k in tkg["dscene"]:
        assert torch.equal(ckg["dscene"][k], tkg["dscene"][k]), k
    for k in STATICS:
        assert ckg[k] == tkg[k], k
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    a = integ.render_samples_regen(ckg, px, py, pidx, 0, 2)[0]
    b = integ.render_samples_regen(tkg, px, py, pidx, 0, 2)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tables_stay_single_level_with_instance_rows(scene):
    kg = port_kg(scene)
    prims, clusters, ct, _walk = TABLES[scene]
    ds = kg["dscene"]
    assert ds["prim_table"].shape[0] == prims
    assert ds["cluster_table"].shape == (clusters, tci.row_width(ct))
    assert kg["cluster_tris"] == ct
    assert kg["has_instances"] and kg["use_brute"] is False
    assert "sc_bounds" not in ds
    # the rows carry their instances' w2o: not all identity
    w2o = ds["cluster_table"][:, :12].numpy()
    eye = np.eye(3, 4, dtype=np.float32).reshape(12)
    assert (w2o != eye).any(1).mean() > 0.9
    # the JAX package packs one-hot tables (K2, K7) only where C <= 512
    assert ("oh_cbounds" in jax_kg(scene)["dscene"]) == (clusters <= 512)


# ---- dispatch --------------------------------------------------------


@pytest.mark.parametrize("scene,fused", [("grid6", False),
                                         ("grid5_nlat15", False),
                                         ("grid5_nlat15", True)])
def test_dispatch_sends_instance_rows_to_the_kernels(scene, fused,
                                                     monkeypatch):
    """A 4x4x1 render through the integrator: which wrappers it calls,
    each with has_instances set (and no other walk)."""
    kg = port_kg(scene)
    if fused:
        kg = {**kg, **tex.FUSED_NEE}
    assert integ._use_fused_nee(kg) == fused
    assert integ._closest_walk_name(kg) == TABLES[scene][3]
    assert integ._use_occlusion_walk(kg)
    calls = []

    def spy(mod, fn):
        orig = getattr(mod, fn)

        def wrapped(*a, **kw):
            calls.append((fn, kw.get("has_instances")))
            return orig(*a, **kw)
        monkeypatch.setattr(mod, fn, wrapped)

    for mod, fn in ((k2, "intersect_clusters_walk"),
                    (k4, "intersect_clusters_tile"),
                    (k3, "occlusion_clusters_walk"),
                    (k7, "intersect_clusters_dual_walk")):
        spy(mod, fn)
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    integ.render_samples_regen(kg, px, py, pidx, 0, 1)
    want = {"grid6": {"intersect_clusters_tile", "occlusion_clusters_walk"},
            "grid5_nlat15": {"intersect_clusters_walk",
                             "occlusion_clusters_walk"}}[scene]
    if fused:
        want = {"intersect_clusters_dual_walk"}
    assert {fn for fn, _ in calls} == want
    assert all(inst is True for _, inst in calls)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_motion_rows_still_raise():
    """What still refuses motion rows, before looking at the device:
    K2, K4, K3, K5 and K6 with instance rows (the JAX package packs no
    table of moving instances), K7 on its own (not ported: no path of
    either package calls it with motion rows); fused-NEE mode never
    serves a scene with them."""
    kg = port_kg("grid5_nlat15")
    ds = kg["dscene"]
    cb, ctab, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    ct = kg["cluster_tris"]
    o, t = torch.zeros((4, 3)), torch.zeros(4)
    vis = torch.ones(4, dtype=torch.int32)
    both = {"has_instances": True, "has_motion": True}
    calls = (
        lambda: k2.intersect_clusters_walk(cb, ctab, ct, o, o, t, t, vis,
                                           **both),
        lambda: k4.intersect_clusters_tile(cb, ctab, ct, o, o, t, t, vis,
                                           **both),
        lambda: k3.occlusion_clusters_walk(cb, ctab, cbd, ct, o, o, t, t, t,
                                           1, 128, **both),
        lambda: k5.intersect_clusters2_walk(cb, cb, ctab, ct, 8, o, o, t, t,
                                            vis, **both),
        lambda: k6.intersect_clusters2_onehot(cb, cb, ctab, ct, 8, o, o, t,
                                              t, vis, **both))
    for call in calls:
        with pytest.raises(NotImplementedError,
                           match="^motion rows with instance rows"):
            call()
    with pytest.raises(NotImplementedError,
                       match="^motion rows in K7 are not ported"):
        k7.intersect_clusters_dual_walk(cb, ctab, ct, o, o, t, t, vis, o, o,
                                        t, t, vis, has_motion=True)
    assert not integ._use_fused_nee(
        {**kg, "fused_nee": True, "cluster_motion": True})


def test_wrappers_refuse_meta_tensors_with_instance_rows():
    """Instance rows no longer raise NotImplementedError: on tensors that
    are not CUDA tensors (meta) each wrapper reaches its argument checks
    and refuses them with ValueError."""
    c, ct = 401, 48
    cb, ctab = _meta((c, 6)), _meta((c, tci.row_width(ct)))
    o, t = _meta((4, 3)), _meta(4)
    vis = _meta(4, torch.int32)
    for call in (
            lambda: k2.intersect_clusters_walk(cb, ctab, ct, o, o, t, t, vis,
                                               has_instances=True),
            lambda: k4.intersect_clusters_tile(cb, ctab, ct, o, o, t, t, vis,
                                               has_instances=True),
            lambda: k3.occlusion_clusters_walk(cb, ctab, _meta((c, ct)), ct,
                                               o, o, t, t, t, 1, 128,
                                               has_instances=True),
            lambda: k7.intersect_clusters_dual_walk(
                cb, ctab, ct, o, o, t, t, vis, o, o, t, t, vis,
                has_instances=True)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors with instance rows the four wrappers return their
    plain versions' results, to the bit, and launch nothing."""
    kg = port_kg("grid5_nlat15")
    ds = kg["dscene"]
    r = rays("grid5_nlat15")
    tabs = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"])
    o, d, tmin, tmax, tmax_a, vis = (_t(r[k]) for k in (
        "o", "d", "tmin", "tmax", "tmax_any", "vis"))
    before = (k2.launches, k3.launches, k4.launches, k7.launches)
    ref = tci.intersect_clusters(*tabs, o, d, tmin, tmax, vis,
                                 has_instances=True)
    for fn in (k2.intersect_clusters_walk, k4.intersect_clusters_tile):
        got = fn(*tabs, o, d, tmin, tmax, vis, has_instances=True)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    occ_args = (ds["cluster_bounds"], ds["cluster_table"],
                ds["cluster_boundary"], kg["cluster_tris"], o, d, tmin,
                tmax_a, tmax_a, 1, 128)
    x = k3.occlusion_clusters_walk(*occ_args, has_instances=True)
    y = tci.occlusion_clusters(*occ_args, has_instances=True)
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    dual_args = (*tabs, o, d, tmin, tmax, vis, o, d, tmin, tmax_a,
                 torch.full_like(vis, ob.PATH_RAY_SHADOW))
    hit, blk = k7.intersect_clusters_dual_walk(*dual_args,
                                               has_instances=True)
    rhit, rblk = tci.intersect_clusters_dual(*dual_args, has_instances=True)
    assert all(torch.equal(hit[k], rhit[k]) for k in hit)
    assert torch.equal(blk, rblk)
    assert torch.equal(hit["prim"], ref["prim"])
    assert (k2.launches, k3.launches, k4.launches, k7.launches) == before


def test_instance_rows_change_the_answer():
    """Without the transform the same rows give other hits: the flag is
    what makes the walk right (the JAX comparisons hold the transformed
    answer)."""
    kg = port_kg("grid6")
    r = rays("grid6")
    a = port_closest(kg, r)
    ds = kg["dscene"]
    b = tci.intersect_clusters(
        ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
        _t(r["o"]), _t(r["d"]), _t(r["tmin"]), _t(r["tmax"]), _t(r["vis"]))
    assert (a["prim"] != b["prim"].numpy()).mean() > 0.1


# ---- K4's visit-order mirrors with instance rows ---------------------


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_mirrors_with_instance_rows(any_hit):
    """On grid=6's table, tile_scan_order and tile_queue_order with
    has_instances equal each other on every output and step count, and
    the plain walk on the hit mask and, off exact-t ties, on every
    output."""
    kg = port_kg("grid6")
    r = rays("grid6")
    ds = kg["dscene"]
    args = (ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
            _t(r["o"]), _t(r["d"]), _t(r["tmin"]),
            _t(r["tmax_any"] if any_hit else r["tmax"]), _t(r["vis"]))
    scan, scnt = k4.tile_scan_order(*args, shadow_any_hit=any_hit,
                                    has_instances=True)
    queue, qcnt = k4.tile_queue_order(*args, shadow_any_hit=any_hit,
                                      has_instances=True)
    for k in scan:
        assert torch.equal(scan[k], queue[k]), k
    assert torch.equal(scnt[:, :2], qcnt[:, :2])
    plain = port_closest(kg, r, any_hit)
    got = {k: v.numpy() for k, v in scan.items()}
    np.testing.assert_array_equal(plain["prim"] >= 0, got["prim"] >= 0)
    if not any_hit:
        tie = (plain["prim"] != got["prim"]) \
            | (plain["object"] != got["object"])
        assert tie.mean() <= TIE_FRAC
        np.testing.assert_array_equal(plain["t"][tie], got["t"][tie])
        for k in got:
            np.testing.assert_array_equal(plain[k][~tie], got[k][~tie])


# ---- K3's plain version against the JAX package's K3 ------------------


def _subset_table(ctab, ct, keep):
    """cluster_table with the prim id of every slot outside `keep`
    ((C, ct) bool) set to -1, so a walk skips those prims."""
    ctab = ctab.copy()
    pb = tci.META_COLS + 9 * ct
    ctab[:, pb:pb + ct] = np.where(keep, ctab[:, pb:pb + ct],
                                   np.float32(-1.0))
    return ctab


def test_occlusion_walk_vs_jax_k3():
    """Both forms in one call (even lanes surface, odd lanes dual) with
    seeded boundary flags (grid=6 has no volume boundary of its own):
    blocked equal; the surface lanes' minima stay at RAY_TMAX; each dual
    minimum equals the plain closest walk's over its subset of prims, and
    the JAX package's to the bit or, where XLA:CPU contracts (within
    CONTRACTED_RTOL of it), the numpy golden of that hit."""
    kg = port_kg("grid6")
    r = rays("grid6")
    ds = kg["dscene"]
    ct = int(kg["cluster_tris"])
    n = len(r["o"])
    g = np.random.default_rng(23)
    cbd = (g.uniform(size=(ds["cluster_bounds"].shape[0], ct))
           < 0.3).astype(np.float32)
    dual = np.arange(n) % 2 == 1
    tmax_c = np.where(dual, np.where(g.uniform(size=n) < 0.5,
                                     g.uniform(1.0, 40.0, n), 1e30),
                      r["tmin"]).astype(np.float32)
    cb, ctab = ds["cluster_bounds"].numpy(), ds["cluster_table"].numpy()
    jb, jo, jblk = pcl.occlusion_clusters_pallas(
        jnp.asarray(cb), jnp.asarray(ctab), jnp.asarray(cbd), ct,
        jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["tmin"]),
        tmax_closest=jnp.asarray(tmax_c),
        tmax_any=jnp.asarray(r["tmax_any"]), vis_closest=ob.PATH_RAY_CAMERA,
        vis_any=ob.PATH_RAY_SHADOW, has_instances=True, interpret=True)
    tb, to, blk = tci.occlusion_clusters(
        _t(cb), _t(ctab), _t(cbd), ct, _t(r["o"]), _t(r["d"]),
        _t(r["tmin"]), _t(tmax_c), _t(r["tmax_any"]), ob.PATH_RAY_CAMERA,
        ob.PATH_RAY_SHADOW, has_instances=True)
    np.testing.assert_array_equal(np.asarray(jblk), blk.numpy())
    assert 0.05 < blk.float().mean() < 0.95
    for got, ref, keep in ((tb, jb, cbd > 0), (to, jo, cbd <= 0)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(got[~dual], np.float32(1e30))
        np.testing.assert_array_equal(ref[~dual], np.float32(1e30))
        sub = tci.intersect_clusters(
            _t(cb), _t(_subset_table(ctab, ct, keep)), ct, _t(r["o"]),
            _t(r["d"]), _t(r["tmin"]), _t(tmax_c), _t(r["vis"]),
            has_instances=True)
        sub = {k: v.numpy() for k, v in sub.items()}
        hit = sub["prim"] >= 0
        np.testing.assert_array_equal(got, np.where(hit, sub["t"],
                                                    np.float32(1e30)))
        assert hit[dual].mean() > 0.05
        off = got != ref
        np.testing.assert_allclose(got[off], ref[off], rtol=CONTRACTED_RTOL)
        for i in np.nonzero(off)[0]:
            gold = golden(ctab, ct, sub["prim"][i], sub["object"][i],
                          r["o"][i], r["d"][i])
            assert got[i] == gold[0], i


# ---- entry points ----------------------------------------------------


@pytest.mark.parametrize("spec,grid,nlat,flags", [
    ("example:instanced_grid6", 6, 12, {}),
    ("example:instanced_grid5_nlat15", 5, 15, {}),
    ("example:instanced_grid5_nlat15:fused", 5, 15, {"fused_nee": True})])
def test_cli_loads_the_configurations(spec, grid, nlat, flags):
    """textured_instanced's width, samples and bounces (256x256, 64 spp,
    max_bounce 4) on the two instanced grids."""
    scene, got = cli.load_scene(spec)
    assert got == flags
    assert (int(scene.camera.width), int(scene.camera.height)) == (256, 256)
    assert int(scene.integrator.aa_samples) == 64
    assert int(scene.integrator.max_bounce) == 4
    assert len(scene.objects) == grid * grid + 1
    assert scene.objects[1].geometry.num_triangles == 2 * nlat * 24 - 48
