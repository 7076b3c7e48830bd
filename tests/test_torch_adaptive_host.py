"""The adaptive drivers planned on the host, in the port against the JAX
package:

- session/adaptive.py render_adaptive, with the same synthetic numpy
  render_chunk (a pure function of pixel and sample index) given to both
  packages' drivers: the counts, the stats, L_sum, A_sum and E_sum are
  equal, exactly, in the four shapes of tests/test_adaptive_driver.py
  (threshold 0; a threshold that saves samples; a wavefront wider than
  the active set; surplus lanes past the milestone) and with surplus
  lanes under a threshold, where the waterfill orders pixels by error;
- render_adaptive_device's on_dispatch hook: one call a round;
- session/session.py render's adaptive branch against the JAX package's
  Session on the same kind of synthetic renderer, each package's
  render_samples_regen replaced within the test only: the per-pixel
  sample counts and the image are equal, exactly;
- one real 16x16 dof_motion_adaptive render through render_adaptive in
  both packages: the image means agree within 1% (the two frameworks
  draw the same samples and round them differently, which can move a
  pixel across the threshold). The real render through the session's
  branch is held in tests/test_torch_dof_render.py, beside the JAX
  Session that renders the slice's reference image.

The synthetic sample values are multiples of 1/16 below 3, so every sum
is exact in float32 and both packages see the same numbers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu.session import adaptive as jadaptive
from raytracingproject_tpu.session.session import (
    Session as JSession, SessionParams)
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session import adaptive
from raytracingproject_tpu_torch.session.session import render

torch.set_num_threads(1)


def _weights(xp, pidx, s):
    """Integer sample weights (..., 3) of pixel pidx at sample s: their
    sum over the samples, over 16, is a chunk's radiance."""
    c = xp.arange(3)
    p, s = pidx[..., None], s[..., None]
    return (p * 31 + s * ((p % 5) + 1) * 7 + c * 3) % 16 + 16 * (p % 3)


def _render_chunk(chunk):
    """A synthetic render_chunk: lane i renders samples s0[i] ..
    s0[i] + chunk - 1 of pixel pidx[i]."""
    def fn(px, py, pidx, s0):
        s = s0.astype(np.int64)[:, None] + np.arange(chunk)
        w = _weights(np, pidx.astype(np.int64)[:, None], s)
        even = (s % 2 == 0)[..., None]
        return ((w.sum(1) / 16.0).astype(np.float32),
                np.full(len(px), float(chunk), np.float32),
                ((w * even).sum(1) / 16.0).astype(np.float32))
    return fn


# (W, spp, threshold, min_samples, chunk, lanes per pixel): the shapes of
# tests/test_adaptive_driver.py, then surplus lanes under a threshold
SHAPES = {
    "threshold_zero": (16, 8, 0.0, None, 2, 1),
    "saves_samples": (16, 32, 0.1, 4, 2, 1),
    "wider_wavefront": (8, 16, 0.0, None, 2, 4),
    "surplus_lanes": (8, 16, 0.0, 8, 2, 8),
    "surplus_lanes_threshold": (8, 32, 0.1, 4, 2, 4),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_render_adaptive_equals_jax(shape):
    W, spp, thr, min_s, chunk, lpp = SHAPES[shape]
    kw = dict(threshold=thr, min_samples=min_s, chunk=chunk,
              lanes=W * W * lpp, render_chunk=_render_chunk(chunk))
    L, A, counts, st = adaptive.render_adaptive(None, W, W, spp, **kw)
    Lj, Aj, cj, stj = jadaptive.render_adaptive(None, W, W, spp, **kw)
    assert st == stj
    np.testing.assert_array_equal(counts, cj)
    assert counts.dtype == cj.dtype
    for got, ref in ((L, Lj), (A, Aj)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    if thr > 0.0:
        assert st["min_samples"] < st["max_samples"] == spp
        assert st["samples_rendered"] < st["samples_nominal"]
    else:
        assert (counts == spp).all()
    if shape == "surplus_lanes":
        assert st["lanes_wasted"] == 0 and st["dispatches"] == 1


def test_render_adaptive_rounds_equal_jax():
    """Every round hands the same lanes to render_chunk. Neither driver
    returns E_sum; the lanes after the first round follow from the counts
    and the errors, which E_sum drives (the waterfill orders surplus lanes
    by error), so equal lanes in every round hold E_sum too."""
    seen = {"port": [], "jax": []}

    def recording(key):
        inner = _render_chunk(2)

        def fn(*lanes):
            seen[key].append([a.copy() for a in lanes])
            return inner(*lanes)
        return fn

    for key, fn in (("port", adaptive.render_adaptive),
                    ("jax", jadaptive.render_adaptive)):
        fn(None, 8, 8, 32, threshold=0.1, min_samples=4, chunk=2,
           lanes=3 * 64, render_chunk=recording(key))
    assert len(seen["port"]) == len(seen["jax"]) > 2
    for a, b in zip(seen["port"], seen["jax"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_device_driver_reports_each_round(monkeypatch):
    """render_adaptive_device calls on_dispatch once a round with the
    round's wall time, as bench.py's adaptive protocol reads it."""
    def chunk(kg, px, py, pidx, s0, n):
        s = s0[:, None] + torch.arange(n)
        w = _weights(torch, pidx[:, None].expand(-1, n), s)
        even = (s % 2 == 0)[..., None]
        return ((w.sum(1) / 16.0).float(), torch.full((len(px),), float(n)),
                ((w * even).sum(1) / 16.0).float())

    monkeypatch.setattr(integ, "render_samples_adaptive_chunk", chunk)
    walls = []
    _L, _A, counts, st = adaptive.render_adaptive_device(
        {"filter_table": torch.zeros(1)}, 8, 8, 16, threshold=0.1,
        min_samples=4, chunk=2, on_dispatch=walls.append)
    assert st["converged"] and len(walls) == st["dispatches"] > 1
    assert all(w >= 0.0 for w in walls) and counts.max() == 16


def _fake_regen_torch(kg, px, py, pixel_index, sample_start, num_samples,
                      lanes_per_pixel=1):
    s = int(sample_start) + torch.arange(num_samples)
    w = _weights(torch, pixel_index[:, None], s[None, :].expand(
        pixel_index.shape[0], -1))
    return ((w.sum(1) / 16.0).to(torch.float32),
            torch.full((px.shape[0],), float(num_samples)))


def _fake_regen_jax(kg, px, py, pixel_index, sample_start, num_samples,
                    *args, **kw):
    s = sample_start.astype(jnp.int32) + jnp.arange(num_samples)
    w = _weights(jnp, pixel_index[:, None],
                 jnp.broadcast_to(s, (pixel_index.shape[0], num_samples)))
    return ((w.sum(1) / 16.0).astype(jnp.float32),
            jnp.full((px.shape[0],), float(num_samples), jnp.float32))


# (W, spp, chunk, adaptive_threshold, adaptive_min_samples,
#  use_adaptive_sampling)
SESSIONS = {
    "threshold": (12, 16, 2, 0.05, 4, False),
    "film_flag_defaults": (8, 24, 4, 0.0, 0, True),
    "ragged_last_chunk": (8, 10, 4, 0.08, 2, False),
}


def _session_scene(ex, case):
    W, spp, _chunk, thr, min_s, flag = SESSIONS[case]
    s = ex.cornell_box(W, W, spp=spp)
    s.integrator.set("adaptive_threshold", thr)
    s.integrator.set("adaptive_min_samples", min_s)
    s.film.set("use_adaptive_sampling", flag)
    return s


@pytest.mark.parametrize("case", sorted(SESSIONS))
def test_session_adaptive_branch_equals_jax(case, monkeypatch):
    W, spp, chunk, *_ = SESSIONS[case]
    monkeypatch.setattr(integ, "render_samples_regen", _fake_regen_torch)
    monkeypatch.setattr(jinteg, "render_samples_regen", _fake_regen_jax)
    st = {}
    img = render(_session_scene(tex, case), spp, chunk=chunk, device="cpu",
                 stats=st)
    sess = JSession(_session_scene(jex, case),
                    SessionParams(samples=spp,
                                  progressive_refine_chunk=chunk))
    rgba = sess.render()
    counts = sess.buffers.per_pixel_samples
    np.testing.assert_array_equal(st["per_pixel_samples"], counts)
    assert st["adaptive"] and st["samples_rendered"] == int(counts.sum())
    assert st["samples_rendered"] < st["samples_nominal"]
    assert counts.max() == spp
    np.testing.assert_array_equal(img, rgba[..., :3].astype(np.float32))


def test_dof_render_adaptive_mean_agrees_with_jax():
    scenes = [ex.dof_motion_scene(16, 16, spp=8) for ex in (tex, jex)]
    for s in scenes:
        s.device_update()
    tkg = scenes[0].make_kernel_globals("cpu")
    jkg = scenes[1].make_kernel_globals()
    kw = dict(threshold=0.02, min_samples=4, chunk=4)
    L, _A, counts, st = adaptive.render_adaptive(tkg, 16, 16, 8, **kw)
    Lj, _Aj, cj, stj = jadaptive.render_adaptive(jkg, 16, 16, 8, **kw)
    mean, mean_j = (L / counts[:, None]).mean(), (Lj / cj[:, None]).mean()
    assert np.isfinite(L).all() and counts.min() >= 4
    assert st["samples_rendered"] < st["samples_nominal"]
    assert st["dispatches"] == stj["dispatches"] == 2
    assert abs(st["samples_rendered"] / stj["samples_rendered"] - 1) <= 0.05
    assert abs(mean / mean_j - 1.0) <= 0.01
