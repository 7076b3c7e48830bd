"""The adaptive loop with its state on the device
(raytracingproject_tpu_torch/session/adaptive.py render_adaptive_device)
against the JAX package's (session/adaptive.py), on the glossy Cornell
box at 16x16, 8 samples in chunks of 2.

With threshold 0 every pixel takes its whole budget: the counts are equal
and the sums agree like two renders of the same samples do (rtol = atol =
2e-4 on >= 99% of the pixels and the mean within 0.5%; the rest is a
Russian-roulette decision flipped by an ulp of drift between the
frameworks, see tests/test_torch_fused_render.py). With a threshold the
two stop pixels by the same rule on nearly the same estimates: the
samples rendered agree within 5% and the image mean within 1%. A loop
ended by max_rounds says so."""

import functools

import numpy as np
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.session import adaptive as jadaptive
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.session import adaptive

torch.set_num_threads(1)
W = H = 16
SPP, CHUNK = 8, 2
THRESHOLD = 0.1


def _port_kg(fused=False):
    s = tex.cornell_box(W, H, spp=SPP, spheres="glossy")
    s.device_update()
    kg = s.make_kernel_globals("cpu")
    if fused:
        kg.update(tex.GLOSSY_FUSED)
    return kg


@functools.lru_cache(maxsize=None)
def _port(threshold, fused=False, max_rounds=None):
    return adaptive.render_adaptive_device(
        _port_kg(fused), W, H, SPP, threshold=threshold, min_samples=2,
        chunk=CHUNK, max_rounds=max_rounds)


@functools.lru_cache(maxsize=None)
def _jax(threshold):
    s = jex.cornell_box(W, H, spp=SPP, spheres="glossy")
    s.device_update()
    return jadaptive.render_adaptive_device(
        s.make_kernel_globals(), W, H, SPP, threshold=threshold,
        min_samples=2, chunk=CHUNK)


def test_threshold_zero_renders_the_whole_budget_like_jax():
    L, A, counts, st = _port(0.0)
    Lj, Aj, cj, stj = _jax(0.0)
    assert counts.dtype == np.int32 and (counts == SPP).all()
    np.testing.assert_array_equal(counts, cj)
    ok = np.isclose(L, Lj, rtol=2e-4, atol=2e-4).all(-1)
    assert ok.mean() >= 0.99, (~ok).sum()
    assert abs(L.mean() / Lj.mean() - 1.0) <= 5e-3
    np.testing.assert_allclose(A, Aj, rtol=2e-4, atol=2e-4)
    assert st["converged"] and st["n_active"] == 0
    assert st["samples_rendered"] == st["samples_nominal"] == W * H * SPP
    assert st["dispatches"] == stj["dispatches"] == SPP // CHUNK


def test_threshold_stops_pixels_early_like_jax():
    L, _A, counts, st = _port(THRESHOLD)
    Lj, _Aj, cj, stj = _jax(THRESHOLD)
    assert st["converged"] and st["n_active"] == 0
    assert st["samples_rendered"] < st["samples_nominal"]
    assert st["min_samples"] >= 2 and st["max_samples"] == SPP
    assert abs(st["samples_rendered"] / stj["samples_rendered"] - 1.0) <= 0.05
    mean = (L / counts[:, None]).mean()
    mean_j = (Lj / cj[:, None]).mean()
    assert abs(mean / mean_j - 1.0) <= 0.01
    # and it is the same image as the whole budget's, to Monte Carlo noise
    full = (_port(0.0)[0] / SPP).mean()
    assert abs(mean / full - 1.0) <= 0.1


@pytest.mark.parametrize("threshold", [0.0, THRESHOLD])
def test_fused_adaptive_equals_unfused(threshold):
    L0, A0, c0, st0 = _port(threshold)
    L1, A1, c1, st1 = _port(threshold, fused=True)
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_allclose(L1, L0, rtol=2e-4, atol=2e-4)
    assert st0 == st1


def test_max_rounds_reports_an_unconverged_loop():
    _L, _A, counts, st = _port(0.0, max_rounds=1)
    assert st["converged"] is False and st["n_active"] == W * H
    assert st["dispatches"] == 1 and (counts == CHUNK).all()


def test_fewer_lanes_than_pixels_still_converges():
    """With half as many lanes as pixels the pixels of highest rank wait
    for a later round; the loop still ends with every count at the
    budget."""
    _L, _A, counts, st = adaptive.render_adaptive_device(
        _port_kg(), W, H, 4, threshold=0.0, chunk=2, lanes=W * H // 2)
    assert st["converged"] and (counts == 4).all()
    assert st["dispatches"] == 4
