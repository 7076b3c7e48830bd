"""K6's contract on the port's plain walk, against the JAX package, on the
big_instanced tables (instanced_scene(grid=8): 1,025 clusters x 38
triangles in 65 superclusters of at most 16 clusters, instance rows):

- the port's plain walk (ops/cluster_intersect.py intersect_clusters with
  has_instances over all C clusters, K6's plain version) against the JAX
  package's K6, intersect_clusters2_onehot in interpret mode, fed the
  bf16x3 group tables that the JAX package packs from the same sc_bounds,
  cluster_bounds and cluster_table (pack_onehot2_tables; the JAX scene's
  own oh2_* tables are equal to them), on 512 seeded rays from inside the
  scene's bounds and 512 camera rays, closest and any hit. Hit masks
  equal, prim and object equal, t rtol 1e-5, u and v atol 1e-5; where
  XLA:CPU contracts a multiply-add of the instance transform or the
  shear (a few percent of the lanes, up to 2e-4 relative) the port's t,
  u, v must equal the float32 numpy golden without contraction, as
  tests/test_torch_cluster2.py holds K5's;
- the dispatch: kg["pallas_onehot2"] selects K6's wrapper, groups past
  its capacity (sc_gmax > 128) fall to K5, the default stays K5, and a
  16x16, 2-spp render with the flag equals the K5 render;
- the wrapper takes the plain version on CPU tensors and refuses what
  the kernel does not take."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import pallas_onehot as po
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.ops import cluster2_walk as k5
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import onehot2_walk as k6
from raytracingproject_tpu_torch.session.session import pixel_wavefront
from tests.test_torch_cluster2 import _compare, _rays, _t

torch.set_num_threads(1)
N_HALF = 512


@pytest.fixture(scope="module")
def scene():
    ts = tex.instanced_scene(16, 16, spp=2, grid=8)
    ts.device_update()
    kg = ts.make_kernel_globals("cpu")
    assert kg["has_instances"] and k6.fits(kg["sc_gmax"])
    return kg


@functools.lru_cache(maxsize=None)
def _oh2_tables():
    """The JAX package's bf16x3 group tables, packed from the port's f32
    tables."""
    ts = tex.instanced_scene(32, 32, spp=2, grid=8)
    ts.device_update()
    a = ts.dscene["arrays"]
    oh2 = po.pack_onehot2_tables(a["sc_bounds"], a["cluster_bounds"],
                                 a["cluster_table"],
                                 int(ts.dscene["sc_gmax"]))
    assert oh2 is not None
    return oh2


def test_jax_scene_packs_the_same_group_tables():
    js = jex.instanced_scene(32, 32, spp=2, grid=8)
    js.device_update()
    ds = js.make_kernel_globals(device_put=False)["dscene"]
    if "oh2_scb" not in ds:
        pytest.skip("the JAX compile declined the oh2 tables")
    for k, v in _oh2_tables().items():
        np.testing.assert_array_equal(
            np.asarray(ds[k]).astype(np.float32),
            np.asarray(v).astype(np.float32), k)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_vs_pallas_k6(scene, any_hit):
    o, d, tmin, tmax_any = _rays()
    n_random = len(o) - 32 * 32
    sel = np.r_[0:N_HALF, n_random:n_random + N_HALF]
    o, d, tmin, tmax_any = o[sel], d[sel], tmin[sel], tmax_any[sel]
    n = len(o)
    tmax = tmax_any if any_hit else np.full(n, 1e30, np.float32)
    oh2 = _oh2_tables()
    ref = po.intersect_clusters2_onehot(
        oh2["oh2_scb"], oh2["oh2_gcb"], oh2["oh2_hi"], oh2["oh2_mid"],
        oh2["oh2_lo"], scene["cluster_tris"], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax),
        jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32),
        shadow_any_hit=any_hit, has_instances=True, interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ds = scene["dscene"]
    got = k6.intersect_clusters2_onehot(
        ds["sc_bounds"], ds["cluster_bounds"], ds["cluster_table"],
        scene["cluster_tris"], scene["sc_gmax"], _t(o), _t(d), _t(tmin),
        _t(tmax), torch.full((n,), ob.PATH_RAY_CAMERA, dtype=torch.int32),
        shadow_any_hit=any_hit, has_instances=True)
    got = {k: v.numpy() for k, v in got.items()}
    _compare(scene, ref, got, o, d, any_hit)


def _spy(monkeypatch):
    calls = []
    for mod, fn in ((k5, "intersect_clusters2_walk"),
                    (k6, "intersect_clusters2_onehot")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            calls.append((_fn, bool(kw.get("shadow_any_hit"))))
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn, spy)
    return calls


def _render(kg, spp=2):
    px, py, pidx = pixel_wavefront(16, 16, 1, "cpu")
    L, _A = integ.render_samples_regen(kg, px, py, pidx, 0, spp)
    return (L / spp).numpy()


def test_dispatch_and_render(scene, monkeypatch):
    calls = _spy(monkeypatch)
    base = _render(scene)
    assert {c[0] for c in calls} == {"intersect_clusters2_walk"}
    del calls[:]
    flagged = _render({**scene, **tex.BIG_INSTANCED_ONEHOT2})
    # K6 for every closest hit and, in its any-hit mode, every shadow test
    assert {c[0] for c in calls} == {"intersect_clusters2_onehot"}
    assert {c[1] for c in calls} == {False, True}
    assert np.isfinite(flagged).all() and flagged.mean() > 0.05
    assert abs(flagged.mean() / base.mean() - 1.0) <= 1e-6
    np.testing.assert_array_equal(flagged, base)
    del calls[:]
    # groups past K6's capacity fall to K5, as when the JAX packing declines
    _render({**scene, "pallas_onehot2": True, "sc_gmax": 136}, spp=1)
    assert {c[0] for c in calls} == {"intersect_clusters2_walk"}
    # K6 is reached only under pallas_clusters2, as in the JAX dispatch
    o = torch.empty((4, 3), device="meta")
    t = torch.empty(4, device="meta")
    with pytest.raises(NotImplementedError, match="K5"):
        integ._scene_intersect_tris(
            {**scene, "pallas_onehot2": True, "pallas_clusters2": False}, o,
            o, t, t, torch.empty(4, dtype=torch.int32, device="meta"))


def test_k6_wrapper_takes_the_plain_version_on_cpu(scene):
    ds = scene["dscene"]
    o, d, tmin, _ = _rays()
    args = (ds["cluster_bounds"], ds["cluster_table"], scene["cluster_tris"],
            _t(o[:256]), _t(d[:256]), _t(tmin[:256]),
            torch.full((256,), 1e30), torch.ones(256, dtype=torch.int32))
    before = k6.launches
    a = k6.intersect_clusters2_onehot(ds["sc_bounds"], *args[:3],
                                      scene["sc_gmax"], *args[3:],
                                      has_instances=True)
    b = tci.intersect_clusters(*args, has_instances=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert k6.launches == before


def test_k6_wrapper_refuses_what_the_kernel_does_not_take(scene):
    ds = scene["dscene"]
    meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in ds.items() if v.ndim == 2}
    o = torch.empty((4, 3), device="meta")
    t1 = torch.empty(4, device="meta")
    vis = torch.empty(4, dtype=torch.int32, device="meta")
    tabs = (meta["sc_bounds"], meta["cluster_bounds"], meta["cluster_table"],
            scene["cluster_tris"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        k6.intersect_clusters2_onehot(*tabs, scene["sc_gmax"], o, o, t1, t1,
                                      vis)
    with pytest.raises(NotImplementedError, match="motion"):
        k6.intersect_clusters2_onehot(*tabs, scene["sc_gmax"], o, o, t1, t1,
                                      vis, has_motion=True)
    assert k6.fits(16) and k6.fits(128)
    assert not k6.fits(129) and not k6.fits(0)
    # 512 superclusters and one group's bounds fit one warp's shared memory
    assert k6.smem_per_warp(512) <= k5.SMEM_BYTES
