"""Image texture sampling (JAX counterpart:
raytracingproject_tpu/ops/texture.py _wrap :28, sample_image :34).

An image lives in a slot of the packed store (models/image.py); the node
knows its slot and the image's true size, so sampling is a gather at the
lanes' (u, v). Procedural noise is not ported.
"""

from __future__ import annotations

import torch

INTERPOLATION_CLOSEST = 0
INTERPOLATION_LINEAR = 1

EXTENSION_REPEAT = 0
EXTENSION_EXTEND = 1
EXTENSION_CLIP = 2


def _wrap(idx, n, extension):
    if extension == EXTENSION_REPEAT:
        return torch.remainder(idx, n)
    return torch.clamp(idx, 0, n - 1)


def sample_image(data, height, width, u, v,
                 interpolation=INTERPOLATION_LINEAR,
                 extension=EXTENSION_REPEAT):
    """Sample one image (Hmax, Wmax, 4) at normalised (u, v), v = 0 at
    the bottom; height, width are the image's true size inside its padded
    slot. Returns (..., 4) RGBA."""
    h, w = int(height), int(width)
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5  # image rows are top-down
    if extension == EXTENSION_CLIP:
        inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    if interpolation == INTERPOLATION_CLOSEST:
        xi = _wrap(torch.floor(x + 0.5).to(torch.int64), w, extension)
        yi = _wrap(torch.floor(y + 0.5).to(torch.int64), h, extension)
        out = data[yi, xi]
    else:
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0w = _wrap(x0, w, extension)
        x1w = _wrap(x0 + 1, w, extension)
        y0w = _wrap(y0, h, extension)
        y1w = _wrap(y0 + 1, h, extension)
        c00 = data[y0w, x0w]
        c01 = data[y0w, x1w]
        c10 = data[y1w, x0w]
        c11 = data[y1w, x1w]
        out = ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
               + (c10 * (1 - fx) + c11 * fx) * fy)
    if extension == EXTENSION_CLIP:
        out = torch.where(inside[..., None], out, 0.0)
    return out
