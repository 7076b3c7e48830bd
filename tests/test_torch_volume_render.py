"""The volume_sss slice as a whole: the port's host compile of
volume_sss_scene against the JAX package's (array-equal tables, the
volume-boundary tables included, and equal per-shader lists, features and
integrator knobs), the kg_from_jax round trip, and a 16x16, 4-spp render
with the configuration's pinned dispatch (examples.VOLUME_SSS_DISPATCH:
K4's plain version, K3's dual form) against the JAX package's render of
the same scene through its XLA cluster walk and the Pallas occlusion
kernel in interpret mode.

The two renders draw the same samples and find the same hits, but the
frameworks round exp, log, sin and cos differently, and an ulp of drift
can flip a rare Russian-roulette, scatter-distance or SSS-entry decision
and send one sample of a pixel down another path. So the images are held
in their converged mean (within 2e-3 + 1%) and pixel by pixel (atol
0.02, rtol 0.05), as tests/test_pallas_cluster.py holds the JAX
package's own dispatches to each other."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models.scene import KG_ARRAYS, kg_from_jax
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
W = H = 16
SPP = 4
# the JAX package's XLA twin of K4 (the integrator passes no interpret
# flag to the Pallas tile walk) with the Pallas occlusion kernel
JAX_DISPATCH = {"use_brute": False, "pallas_clusters": False,
                "pallas_onehot": False, "pallas_occlusion": True,
                "pallas_interpret": True}
STATICS = ("shader_has_volume", "shader_volume_only", "shader_het_volume",
           "shader_vol_sampling", "volume_stack_depth", "use_brute",
           "cluster_tris", "light_kinds")


@pytest.fixture(scope="module")
def pair():
    js = jex.volume_sss_scene(W, H, spp=SPP)
    js.device_update()
    jkg = js.make_kernel_globals(device_put=False)
    ts = tex.volume_sss_scene(W, H, spp=SPP)
    ts.device_update()
    return jkg, ts.make_kernel_globals("cpu")


@pytest.mark.parametrize("name", KG_ARRAYS)
def test_scene_arrays_equal(pair, name):
    jkg, tkg = pair
    ref = np.asarray(jkg["dscene"][name])
    got = tkg["dscene"][name].numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def test_volume_boundary_tables(pair):
    """The smoke box's 12 prims are the scene's volume boundary."""
    _jkg, tkg = pair
    ds = tkg["dscene"]
    assert int(ds["prim_is_boundary"].sum()) == 12
    assert int(ds["cluster_boundary"].sum()) == 12
    assert ds["prim_table"].shape[0] == 1008


def test_statics_equal(pair):
    jkg, tkg = pair
    assert jkg["kint"] == tkg["kint"]
    for k in STATICS:
        assert list(np.atleast_1d(jkg[k])) == list(np.atleast_1d(tkg[k])), k
    np.testing.assert_array_equal(np.asarray(jkg["shader_sigma_max"]),
                                  tkg["shader_sigma_max"])
    # the JAX compile picks the dense sweep at 1,008 prims; the
    # configuration pins the cluster walks instead
    assert tkg["use_brute"] is True
    # the boolean feature flags the JAX compile raises (it also carries
    # AO/bevel node settings there)
    on = {k for k, v in jkg["features"].items() if v is True}
    assert on == {k for k, v in tkg["features"].items() if v}
    for k in ("has_volume", "has_subsurface", "has_equiangular",
              "has_transparent"):
        assert tkg["features"][k], k


def test_kg_from_jax_round_trip(pair):
    """Converted kernel globals carry the same arrays and statics and
    render the same image bit for bit as the port's own compile."""
    jkg, tkg = pair
    ckg = kg_from_jax(jkg, "cpu")
    for k in KG_ARRAYS:
        assert torch.equal(ckg["dscene"][k], tkg["dscene"][k]), k
    for k in STATICS + ("features",):
        assert ckg[k] == tkg[k], k
    px, py, pidx = pixel_wavefront(4, 4, 1, "cpu")
    a = integ.render_samples_regen({**ckg, **tex.VOLUME_SSS_DISPATCH}, px,
                                   py, pidx, 0, 2)[0]
    b = integ.render_samples_regen({**tkg, **tex.VOLUME_SSS_DISPATCH}, px,
                                   py, pidx, 0, 2)[0]
    assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_image():
    js = jex.volume_sss_scene(W, H, spp=SPP)
    js.device_update()
    kg = {**js.make_kernel_globals(), **JAX_DISPATCH}
    yy, xx = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    L, _A = jax.jit(lambda a, b, c: jinteg.render_samples_regen(
        kg, a, b, c, 0, SPP))(px, py, py * W + px)
    return np.asarray(L).reshape(H, W, 3) / SPP


def test_render_matches_jax(pair):
    _jkg, tkg = pair
    kg = {**tkg, **tex.VOLUME_SSS_DISPATCH}
    px, py, pidx = pixel_wavefront(W, H, 1, "cpu")
    L, A = integ.render_samples_regen(kg, px, py, pidx, 0, SPP)
    assert torch.equal(A, torch.full_like(A, float(SPP)))
    got = (L / SPP).numpy().reshape(H, W, 3)
    ref = _jax_image()
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert abs(got.mean() - ref.mean()) < 2e-3 + 0.01 * ref.mean()
    np.testing.assert_allclose(got, ref, atol=0.02, rtol=0.05)


def test_cuda_dispatch_refuses_the_plain_walk(pair):
    """On the card a kg that selects neither K2 nor K4 raises: the plain
    walk is never the render path there (checked on meta tensors, which
    are not CPU tensors)."""
    _jkg, tkg = pair
    kg = {**tkg, "use_brute": False, "pallas_onehot": False,
          "pallas_clusters": False}
    o = torch.empty((4, 3), device="meta")
    t = torch.empty(4, device="meta")
    with pytest.raises(NotImplementedError):
        integ._scene_intersect_tris(kg, o, o, t, t,
                                    torch.empty(4, dtype=torch.int32,
                                                device="meta"))
    # the JAX compile's own choice, the dense sweep, goes to K1, whose
    # wrapper refuses tensors that are not CUDA tensors: no plain sweep
    with pytest.raises(ValueError, match="CUDA tensor"):
        integ._scene_intersect_tris(
            tkg, o, o, t, t, torch.empty(4, dtype=torch.int32, device="meta"))
