"""Volume scattering and subsurface closures of the port against the JAX
package on seeded numpy inputs: every ported function of ops/volume.py
(Henyey-Greenstein eval and sampling, homogeneous distance sampling and
its pdf, equiangular sampling and its pdf, the emission integral, the
masked volume-shader dispatch), the closures the volume_sss scene's
shaders evaluate to, and bsdf_eval / bsdf_sample with the subsurface and
transparent lobes.

Values are held to rtol 1e-5 (float32 rounding of the same expressions;
XLA:CPU and torch round exp, log, atan2, tan, sin and cos differently by
an ulp or two); unit directions, whose components pass through zero, to
atol 1e-5; closure weights, which are constants of the shader graphs, to
the bit. The equiangular pdfs divide by the angle span, a difference of
two atan2 values, so they are held to rtol 1e-4; the equiangular distance
to a tolerance that follows the slope of its tangent (see the test)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import bsdf as jb
from raytracingproject_tpu.ops import closures as jcl
from raytracingproject_tpu.ops import shade as jshade
from raytracingproject_tpu.ops import volume as jv
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.ops import bsdf as tb
from raytracingproject_tpu_torch.ops import closures as tcl
from raytracingproject_tpu_torch.ops import shade as tshade
from raytracingproject_tpu_torch.ops import volume as tv

torch.set_num_threads(1)
N = 4096


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _f32(r, lo, hi, shape):
    return r.uniform(lo, hi, shape).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    """Run the JAX and the torch function on the same numpy inputs."""
    ref = fn_j(*(jnp.asarray(a) for a in arrays))
    got = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays))
    return ref, got


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_hg_phase_eval():
    r = np.random.default_rng(0)
    cos = _f32(r, -1, 1, N)
    g = _f32(r, -0.9, 0.9, N)
    ref, got = _both(jv.hg_phase_eval, tv.hg_phase_eval, cos, g)
    _close(got.numpy(), ref)


def test_hg_phase_sample():
    """Same directions (isotropic lanes with |g| < 1e-3 included) and the
    same pdf as JAX."""
    r = np.random.default_rng(1)
    d = _unit(r, N)
    g = _f32(r, -0.9, 0.9, N)
    g[::7] = 0.0
    u1, u2 = _f32(r, 0, 1, (2, N))
    (jd, jp), (td, tp) = _both(jv.hg_phase_sample, tv.hg_phase_sample,
                               d, g, u1, u2)
    _close(td.numpy(), jd, rtol=0, atol=1e-5)
    _close(tp.numpy(), jp, rtol=1e-5)


def _medium(seed):
    r = np.random.default_rng(seed)
    sigma = _f32(r, 0.0005, 0.02, (N, 3))
    thr = _f32(r, 0, 1, (N, 3))
    thr[::11] = 0.0     # the uniform channel fallback
    t_max = _f32(r, 1, 500, N)
    return r, sigma, thr, t_max


def test_sample_distance_homogeneous():
    r, sigma, thr, t_max = _medium(2)
    u_dist, u_chan = _f32(r, 0, 1, (2, N))
    ref, got = _both(jv.sample_distance_homogeneous,
                     tv.sample_distance_homogeneous,
                     sigma, thr, t_max, u_dist, u_chan)
    np.testing.assert_array_equal(got["scatter"].numpy(),
                                  np.asarray(ref["scatter"]))
    assert 0.1 < got["scatter"].float().mean() < 0.9
    for k in ("t_scatter", "weight_scatter", "weight_pass",
              "transmittance"):
        _close(got[k].numpy(), ref[k], rtol=1e-5)


def test_distance_pdf():
    r, sigma, thr, _t_max = _medium(3)
    t = _f32(r, 0, 300, N)
    ref, got = _both(jv.distance_pdf, tv.distance_pdf, sigma, thr, t)
    _close(got.numpy(), ref)


def _equiangular_inputs(seed):
    r = np.random.default_rng(seed)
    o = _f32(r, 0, 550, (N, 3))
    d = _unit(r, N)
    t_max = _f32(r, 1, 600, N)
    light = _f32(r, 200, 350, (N, 3))
    light[:, 1] = 548.0
    light[::13] = o[::13] + d[::13] * 50.0   # on the ray's axis: invalid
    return r, o, d, t_max, light


def test_equiangular_sample():
    r, o, d, t_max, light = _equiangular_inputs(4)
    u = _f32(r, 0, 1, N)
    (jt, jp, jok), (tt, tp, tok) = _both(
        jv.equiangular_sample, tv.equiangular_sample, o, d, t_max, light, u)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0.5 < tok.float().mean() < 1.0
    ok = np.asarray(jok)
    # t = delta + D tan(theta): an error of a few ulps in the angle moves
    # t by D / cos^2(theta) times it, which is large near +-pi/2. Hold t
    # to 1e-5 of the segment plus 8 ulps of the angle through that slope
    # (computed per lane in float64).
    o64, d64, l64 = (x.astype(np.float64) for x in (o, d, light))
    to_l = l64 - o64
    delta = np.sum(to_l * d64, -1)
    D = np.sqrt(np.maximum(np.sum(to_l * to_l, -1) - delta * delta, 0.0))
    th_a = -np.arctan2(delta, D)
    span = np.arctan2(t_max - delta, D) - th_a
    theta = th_a + u * span
    slope = D / np.maximum(np.cos(theta) ** 2, 1e-300)
    tol = 1e-5 * t_max + 8 * 2.0 ** -24 * (np.abs(th_a) + np.abs(span)) \
        * slope
    dt = np.abs(tt.numpy().astype(np.float64) - np.asarray(jt))
    assert (dt[ok] <= tol[ok]).all(), (dt - tol)[ok].max()
    _close(tp.numpy()[ok], np.asarray(jp)[ok], rtol=1e-4)


def test_equiangular_pdf():
    r, o, d, t_max, light = _equiangular_inputs(5)
    t = _f32(r, 0, 1, N) * t_max
    ref, got = _both(jv.equiangular_pdf, tv.equiangular_pdf, o, d, t_max,
                     light, t)
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(ref) > 0)
    _close(got.numpy(), ref, rtol=1e-4)


def test_emission_integral():
    r, sigma, _thr, t_max = _medium(6)
    e = _f32(r, 0, 5, (N, 3))
    sigma[::5] = 0.0    # the clamp of a vacuum channel
    ref, got = _both(jv.emission_integral, tv.emission_integral, e, sigma,
                     t_max)
    _close(got.numpy(), ref)


@pytest.fixture(scope="module")
def volume_scenes():
    js = jex.volume_sss_scene(16, 16, spp=2)
    js.device_update()
    jkg = js.make_kernel_globals(device_put=False)
    ts = tex.volume_sss_scene(16, 16, spp=2)
    ts.device_update()
    return jkg, ts.make_kernel_globals("cpu")


def test_volume_closures(volume_scenes):
    """The masked volume-shader dispatch over random medium slots (-1 =
    vacuum) gives the JAX package's sigma_t, sigma_s, emission and g."""
    jkg, tkg = volume_scenes
    nsh = len(tkg["shaders"])
    assert tkg["shader_has_volume"] == list(jkg["shader_has_volume"])
    slots = np.random.default_rng(7).integers(-1, nsh, N).astype(np.int32)
    ref = jv.eval_volume_closures(
        jkg["shaders"], jkg["shader_has_volume"], jnp.asarray(slots), N,
        jshade.ShaderData(batch_shape=(N,)))
    got = tv.eval_volume_closures(
        tkg["shaders"], tkg["shader_has_volume"], torch.from_numpy(slots), N,
        tshade.ShaderData(batch_shape=(N,), device="cpu"))
    for k in ("sigma_t", "sigma_s", "v_emission", "anisotropy"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert (got["sigma_t"].numpy() > 0).any()


def test_surface_closures_with_subsurface(volume_scenes):
    """Every shader's surface closures (the SSS sphere's subsurface
    color, radius and falloff flag, the volume-only boundary's empty
    stack) equal the JAX package's in every slot the port carries."""
    jkg, tkg = volume_scenes
    nsh = len(tkg["shaders"])
    slots = np.random.default_rng(8).integers(0, nsh, N).astype(np.int32)
    ref = jshade.eval_shaders(jkg["shaders"],
                              jshade.ShaderData(batch_shape=(N,)),
                              jnp.asarray(slots))
    got = tshade.eval_shaders(tkg["shaders"],
                              tshade.ShaderData(batch_shape=(N,),
                                                device="cpu"),
                              torch.from_numpy(slots))
    for k in tcl.CLOSURE_VEC_KEYS + tcl.CLOSURE_SCALAR_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert (got["subsurface"].numpy() > 0).any()


def _sss_inputs(seed):
    r = np.random.default_rng(seed)
    n_ = _unit(r, N)
    i_ = _unit(r, N)
    cos = np.sum(i_ * n_, -1, keepdims=True)
    i_ = np.where(cos < 0, -i_, i_)
    i_ = i_ + n_ * np.maximum(0.05 - np.sum(i_ * n_, -1, keepdims=True), 0)
    i_ = (i_ / np.linalg.norm(i_, axis=1, keepdims=True)).astype(np.float32)
    w = {k: _f32(r, 0, 1, (N, 3)) for k in ("diffuse", "subsurface",
                                            "transparent")}
    # lanes with only one of the lobes
    w["subsurface"][0::4] = 0.0
    w["transparent"][1::4] = 0.0
    w["diffuse"][2::4] = 0.0
    return r, n_, i_, w


def _closure_pair(w):
    jc = jcl.empty_closures((N,))
    tc = tcl.empty_closures((N,), "cpu")
    for k, v in w.items():
        jc[k] = jnp.asarray(v)
        tc[k] = torch.from_numpy(v)
    return jc, tc


# the volume_sss lobe set, with and without the random-walk integrator
# taking the subsurface lobe
FEATURES = [
    {"has_glossy": False, "has_refraction": False, "has_transparent": True,
     "has_diffuse_roughness": False, "has_subsurface": sss}
    for sss in (True, False)]


@pytest.mark.parametrize("features", FEATURES,
                         ids=["sss_walk", "sss_as_diffuse"])
def test_bsdf_eval_subsurface(features):
    r, n_, i_, w = _sss_inputs(9)
    jc, tc = _closure_pair(w)
    omega = _unit(r, N)
    fr, pr = jb.bsdf_eval(jc, jnp.asarray(n_), jnp.asarray(i_),
                          jnp.asarray(omega), features)
    fg, pg = tb.bsdf_eval(tc, torch.from_numpy(n_), torch.from_numpy(i_),
                          torch.from_numpy(omega), features)
    _close(fg.numpy(), fr)
    _close(pg.numpy(), pr)
    assert (pg.numpy() > 0).mean() > 0.3


@pytest.mark.parametrize("features", FEATURES,
                         ids=["sss_walk", "sss_as_diffuse"])
def test_bsdf_sample_subsurface(features):
    """Same lobe picks (diffuse or the transparent pass-through), labels,
    directions, f and pdf as JAX."""
    r, n_, i_, w = _sss_inputs(10)
    jc, tc = _closure_pair(w)
    u1, u2, ul = _f32(r, 0, 1, (3, N))
    ref = jb.bsdf_sample(jc, jnp.asarray(n_), jnp.asarray(n_),
                         jnp.asarray(i_), jnp.asarray(u1), jnp.asarray(u2),
                         jnp.asarray(ul), features)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    nt, it = torch.from_numpy(n_), torch.from_numpy(i_)
    got = tb.bsdf_sample(tc, nt, nt, it, torch.from_numpy(u1),
                         torch.from_numpy(u2), torch.from_numpy(ul),
                         features)
    np.testing.assert_array_equal(got["label"].numpy(), ref["label"])
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    transparent = (ref["label"] & tb.LABEL_TRANSPARENT) > 0
    assert 0.05 < transparent.mean() < 0.95
    _close(got["omega"].numpy(), ref["omega"], rtol=0, atol=1e-5)
    _close(got["f_cos"].numpy(), ref["f_cos"], rtol=1e-5, atol=1e-7)
    _close(got["pdf"].numpy(), ref["pdf"], rtol=1e-5)
