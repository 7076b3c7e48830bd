"""Render loop (JAX counterpart: raytracingproject_tpu/session/session.py
Session._run :337-470, for one full-frame tile).

`render` compiles the scene (unless KernelGlobals are given) and returns
the (H, W, 3) float32 image. A scene that declares adaptive sampling
(`integrator.adaptive_threshold` > 0 or `film.use_adaptive_sampling`)
takes the session's adaptive branch, `render_adaptive_film`; every other
scene the fixed loop, `render_fixed`. Both loop sample chunks over
ops/integrator.py render_samples_regen. The wavefront drivers of
session/adaptive.py are separate entry points. Tiles, pause and
multi-device rendering are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch.device import get_device
from raytracingproject_tpu_torch.ops import integrator as integ


def pixel_wavefront(width, height, lanes_per_pixel, device):
    """(px, py, pixel_index) int64 lanes, tiled lanes_per_pixel times."""
    yy, xx = np.mgrid[0:height, 0:width]
    px = torch.as_tensor(xx.reshape(-1), device=device).long()
    py = torch.as_tensor(yy.reshape(-1), device=device).long()
    pidx = py * width + px
    k = int(lanes_per_pixel)
    return px.repeat(k), py.repeat(k), pidx.repeat(k)


def _film_size(kg):
    return int(kg["cam"]["width"]), int(kg["cam"]["height"])


def render_fixed(kg, samples, chunk=16, lanes_per_pixel=1):
    """Every pixel takes `samples` samples, in chunks of `chunk`; returns
    the (H, W, 3) float32 numpy image."""
    width, height = _film_size(kg)
    dev = kg["filter_table"].device
    px, py, pidx = pixel_wavefront(width, height, lanes_per_pixel, dev)
    acc = torch.zeros((width * height, 3), device=dev)
    for start in range(0, samples, chunk):
        L, _A = integ.render_samples_regen(
            kg, px, py, pidx, start, min(chunk, samples - start),
            lanes_per_pixel)
        acc = acc + L
    img = (acc / samples).reshape(height, width, 3)
    return img.cpu().numpy()


def _adaptive_error(L_sum, E_sum, n):
    """The half-buffer error of each pixel after n samples: sum|L - 2E|
    / (n * sqrt(mean)), E the sum over the chunks of even index."""
    n = max(n, 1)
    mean = L_sum / n
    return np.abs(L_sum - 2.0 * E_sum).sum(-1) / (
        n * np.sqrt(np.maximum(mean.sum(-1), 1e-4)))


def render_adaptive_film(kg, samples, chunk, threshold, min_samples,
                         lanes_per_pixel=1):
    """The session's adaptive branch. Each chunk renders the current list
    of active pixels (at first all of them) through render_samples_regen;
    E takes the chunks of even chunk index. Once the frame has
    min_samples samples, each chunk ends with the error test over every
    pixel, against the frame's sample count, and the pixels at or above
    the threshold are the next list; the loop stops when the list is
    empty or the budget is spent. Returns the (H, W, 3) float32 image,
    each pixel's sum over its own sample count, and the (H, W) int32
    counts."""
    width, height = _film_size(kg)
    dev = kg["filter_table"].device
    npix = width * height
    K = int(lanes_per_pixel)
    L_sum = np.zeros((npix, 3), np.float32)
    E_sum = np.zeros((npix, 3), np.float32)
    counts = np.zeros(npix, np.int32)
    active = np.arange(npix)
    for parity, start in enumerate(range(0, samples, chunk)):
        num = min(chunk, samples - start)
        pix = torch.as_tensor(active, device=dev).repeat(K)
        L, _A = integ.render_samples_regen(kg, pix % width, pix // width,
                                           pix, start, num, K)
        L = L.cpu().numpy()
        L_sum[active] += L
        if parity % 2 == 0:
            E_sum[active] += L
        counts[active] += num
        if start + num >= min_samples:
            active = np.flatnonzero(
                _adaptive_error(L_sum, E_sum, start + num) >= threshold)
            if active.size == 0:
                break
    img = L_sum * (1.0 / np.maximum(counts, 1))[:, None]
    return (img.astype(np.float32).reshape(height, width, 3),
            counts.reshape(height, width))


def _adaptive_settings(scene, samples):
    """(threshold, min_samples) of a scene that declares adaptive
    sampling, else None: the threshold defaults to 0.01, min_samples to
    max(samples // 8, 8)."""
    thr = float(scene.integrator.adaptive_threshold)
    if thr <= 0.0 and not bool(scene.film.use_adaptive_sampling):
        return None
    return (thr or 0.01, int(scene.integrator.adaptive_min_samples)
            or max(samples // 8, 8))


def render(scene, samples=None, chunk=16, device="cuda", lanes_per_pixel=1,
           kg=None, stats=None):
    """Render `samples` samples per pixel (default the scene's
    aa_samples) in chunks of `chunk`, adaptively where the scene says so;
    returns the (H, W, 3) float32 numpy image. A `stats` dict, if given,
    receives "adaptive", "samples_rendered" and "samples_nominal", and
    from an adaptive render "per_pixel_samples", the (H, W) counts."""
    dev = get_device(device) if isinstance(device, str) else device
    if kg is None:
        scene.device_update()
        kg = scene.make_kernel_globals(dev)
    samples = int(samples or kg["kint"]["aa_samples"])
    width, height = _film_size(kg)
    settings = _adaptive_settings(scene, samples)
    rendered = width * height * samples
    if settings is None:
        img = render_fixed(kg, samples, chunk, lanes_per_pixel)
    else:
        img, counts = render_adaptive_film(kg, samples, chunk, *settings,
                                           lanes_per_pixel)
        rendered = int(counts.sum())
        if stats is not None:
            stats["per_pixel_samples"] = counts
    if stats is not None:
        stats.update(adaptive=settings is not None,
                     samples_rendered=rendered,
                     samples_nominal=width * height * samples)
    return img
