"""Render loop (JAX counterpart: raytracingproject_tpu/session/session.py
Session._run :348, for one full-frame tile).

`render` compiles the scene (unless KernelGlobals are given), loops
sample chunks over ops/integrator.py render_samples_regen and returns
the (H, W, 3) float32 image averaged over the samples. The adaptive
sampler is a loop of its own (session/adaptive.py
render_adaptive_device); `render` has no adaptive branch. Tiles, pause
and multi-device rendering are not ported.
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


def render(scene, samples=None, chunk=16, device="cuda", lanes_per_pixel=1,
           kg=None):
    """Render `samples` samples per pixel in chunks of `chunk`; returns
    the (H, W, 3) float32 numpy image."""
    dev = get_device(device) if isinstance(device, str) else device
    if kg is None:
        scene.device_update()
        kg = scene.make_kernel_globals(dev)
    width, height = int(kg["cam"]["width"]), int(kg["cam"]["height"])
    samples = int(samples or kg["kint"]["aa_samples"])
    px, py, pidx = pixel_wavefront(width, height, lanes_per_pixel, dev)
    acc = torch.zeros((width * height, 3), device=dev)
    for start in range(0, samples, chunk):
        L, _A = integ.render_samples_regen(
            kg, px, py, pidx, start, min(chunk, samples - start),
            lanes_per_pixel)
        acc = acc + L
    img = (acc / samples).reshape(height, width, 3)
    return img.cpu().numpy()
