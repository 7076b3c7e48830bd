"""Fused-NEE mode of the port (ops/integrator.py: one union walk per
bounce answers the NEE shadow test and the next ray's closest hit) and
the render loops it runs under, on the glossy Cornell box.

Against the JAX package (its fused mode runs the union-walk Pallas kernel
in interpret mode, as tests/test_fused_nee.py runs it): the regenerating
loop at 32x32, 2 samples, and the adaptive chunk at 16x16, 2 samples,
fused and unfused. Both packages draw the same samples and find the same
hits, but they round rsqrt, sin and cos differently and an ulp of drift
can flip a rare Russian-roulette decision, which sends one sample of a
pixel down another path (both estimates stay correct). So the sums are
held to rtol = atol = 2e-4 on at least 99% of the pixels, and the image
mean to 0.5%.

Inside the port the JAX package's own invariants of the mode
(tests/test_fused_nee.py): the fixed grid equals the regenerating loop
to the bit, fused and unfused; fused equals unfused to 2e-4; two lanes
per pixel equal one to 1e-5. And the window a regenerated camera ray is
traced in: with a far clip that cuts the back wall off, the port's fused
render equals its unfused one, where the JAX package's does not."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session.session import pixel_wavefront

torch.set_num_threads(1)
TOL = 2e-4
FARCLIP = 1200.0   # the camera stands 1,359 in front of the back wall


def _port_kg(size, fused, farclip=None, scene=None):
    s = scene or tex.cornell_box(size, size, spp=2, spheres="glossy")
    if farclip:
        s.camera.set("farclip", farclip)
    s.device_update()
    kg = s.make_kernel_globals("cpu")
    if fused:
        kg.update(tex.GLOSSY_FUSED)
    return kg


def _jax_kg(size, fused, farclip=None):
    s = jex.cornell_box(size, size, spp=2, spheres="glossy")
    if farclip:
        s.camera.set("farclip", farclip)
    s.device_update()
    kg = s.make_kernel_globals()
    if fused:
        kg = {**kg, "fused_nee": True, "pallas_interpret": True,
              "pallas_onehot": True}
        assert jinteg._use_fused_nee(kg)
    return kg


def _jax_lanes(size):
    yy, xx = np.mgrid[0:size, 0:size]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    return px, py, py * size + px


def _port_regen(size, fused, spp=2, lpp=1, farclip=None):
    kg = _port_kg(size, fused, farclip)
    assert integ._use_fused_nee(kg) == fused
    return integ.render_samples_regen(
        kg, *pixel_wavefront(size, size, lpp, "cpu"), 0, spp, lpp)


@functools.lru_cache(maxsize=None)
def _jax_regen(size, fused, farclip=None):
    L, A = jinteg.render_samples_regen(_jax_kg(size, fused, farclip),
                                       *_jax_lanes(size), 0, 2)
    return np.asarray(L), np.asarray(A)


def _assert_sums_agree(got, ref):
    """rtol = atol = 2e-4 on >= 99% of the pixels (the rest: a flipped
    roulette decision), the mean within 0.5%."""
    got, ref = np.asarray(got), np.asarray(ref)
    ok = np.isclose(got, ref, rtol=TOL, atol=TOL)
    if ok.ndim > 1:
        ok = ok.all(-1)
    assert ok.mean() >= 0.99, (~ok).sum()
    assert abs(got.mean() / ref.mean() - 1.0) <= 5e-3
    assert np.isfinite(got).all()


def test_fused_regen_matches_jax_fused_regen():
    L, A = _port_regen(32, True)
    Lj, Aj = _jax_regen(32, True)
    _assert_sums_agree(L, Lj)
    np.testing.assert_allclose(A.numpy(), Aj, rtol=TOL, atol=TOL)
    assert float(L.mean()) > 0.01


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_fixed_grid_equals_regen_to_the_bit(fused):
    kg = _port_kg(16, fused)
    lanes = pixel_wavefront(16, 16, 1, "cpu")
    Lf, Af = integ.render_samples(kg, *lanes, 0, 3)
    Lr, Ar = integ.render_samples_regen(kg, *lanes, 0, 3)
    assert torch.equal(Lf, Lr) and torch.equal(Af, Ar)
    assert float(Lf.mean()) > 0.01


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_path_trace_sample_is_one_sample_of_the_grid(fused):
    kg = _port_kg(16, fused)
    lanes = pixel_wavefront(16, 16, 1, "cpu")
    L0, A0, aux = integ.path_trace_sample(kg, *lanes, 0)
    L1, A1, _ = integ.path_trace_sample(kg, *lanes, 1)
    L, A = integ.render_samples(kg, *lanes, 0, 2)
    assert aux == {}
    assert torch.equal(L0 + L1, L) and torch.equal(A0 + A1, A)


def test_fused_matches_unfused():
    L0, A0 = _port_regen(32, False)
    L1, A1 = _port_regen(32, True)
    np.testing.assert_allclose(L1.numpy(), L0.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(A1.numpy(), A0.numpy(), rtol=TOL, atol=TOL)
    assert float(L1.mean()) > 0.01


def test_lanes_per_pixel_fused():
    L0, _A0 = _port_regen(16, True, spp=4)
    L1, _A1 = _port_regen(16, True, spp=4, lpp=2)
    np.testing.assert_allclose(L1.numpy(), L0.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_adaptive_chunk_matches_jax(fused):
    size, n = 16, 256
    # per-lane first samples: even and odd, so E differs from L
    s0 = np.arange(n) % 3
    L, A, E = integ.render_samples_adaptive_chunk(
        _port_kg(size, fused), *pixel_wavefront(size, size, 1, "cpu"),
        torch.from_numpy(s0), 2)
    Lj, Aj, Ej = jinteg.render_samples_adaptive_chunk(
        _jax_kg(size, fused), *_jax_lanes(size), jnp.asarray(s0, jnp.uint32),
        2)
    _assert_sums_agree(L, Lj)
    _assert_sums_agree(E, Ej)
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=TOL, atol=TOL)
    assert 0.0 < float(E.sum()) < float(L.sum())


def test_adaptive_chunk_is_the_regen_sum():
    """From sample 0 on every lane the chunk's L is the regenerating
    loop's, and E is its sample 0 alone."""
    kg = _port_kg(16, True)
    lanes = pixel_wavefront(16, 16, 1, "cpu")
    L, A, E = integ.render_samples_adaptive_chunk(
        kg, *lanes, torch.zeros(256, dtype=torch.int64), 2)
    Lr, Ar = integ.render_samples_regen(kg, *lanes, 0, 2)
    assert torch.equal(L, Lr) and torch.equal(A, Ar)
    assert torch.equal(E, integ.render_samples_regen(kg, *lanes, 0, 1)[0])


def test_regenerated_camera_ray_keeps_its_own_window():
    """A far clip in front of the back wall. A regenerated lane's camera
    ray must stop at the clip like its first sample's: the port's fused
    render then equals its unfused one. The JAX package traces that ray to
    the finished path's tmax, sees the wall behind the clip from the
    second sample on, and its fused render leaves its unfused one."""
    L0, _ = _port_regen(16, False, farclip=FARCLIP)
    L1, _ = _port_regen(16, True, farclip=FARCLIP)
    np.testing.assert_allclose(L1.numpy(), L0.numpy(), rtol=TOL, atol=TOL)
    # the clip does cut the wall off: the render differs from the unclipped
    Lfull, _ = _port_regen(16, False)
    assert float((Lfull - L0).abs().max()) > 0.05
    _assert_sums_agree(L0, _jax_regen(16, False, FARCLIP)[0])
    Lj0, Lj1 = _jax_regen(16, False, FARCLIP)[0], _jax_regen(16, True,
                                                             FARCLIP)[0]
    assert not np.allclose(Lj1, Lj0, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scene", ["volume_sss", "cornell"])
def test_scenes_the_mode_does_not_serve_render_unfused(scene):
    """volume_sss (its own dual sweep) and the dense cornell_diffuse are
    outside fused mode's list: the flag changes nothing."""
    def make():
        return (tex.volume_sss_scene(8, 8, spp=2) if scene == "volume_sss"
                else tex.cornell_box(8, 8, spp=2))
    kg0 = _port_kg(8, False, scene=make())
    kg1 = _port_kg(8, True, scene=make())
    assert kg1["fused_nee"] and not integ._use_fused_nee(kg1)
    lanes = pixel_wavefront(8, 8, 1, "cpu")
    assert len(integ.make_path_kernel(kg1, *lanes)) == 2
    L0, _ = integ.render_samples_regen(kg0, *lanes, 0, 2)
    L1, _ = integ.render_samples_regen(kg1, *lanes, 0, 2)
    assert torch.equal(L0, L1) and float(L0.mean()) > 0.0


def test_fused_needs_the_per_lane_walk_flag():
    kg = _port_kg(8, True)
    assert integ._use_fused_nee(kg)
    assert not integ._use_fused_nee({**kg, "pallas_onehot": False})
    assert not integ._use_fused_nee({**kg, "fused_nee": False})
