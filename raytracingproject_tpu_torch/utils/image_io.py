"""PNG output (JAX counterpart: raytracingproject_tpu/utils/image_io.py
write_png :18), written with the standard library's zlib so the port
needs no imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body \
        + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def write_png(path, rgb, srgb=True):
    """Write an (H, W, 3) float image in [0, inf) to an 8-bit RGB PNG,
    sRGB-encoded like the JAX package's writer."""
    arr = np.asarray(rgb, np.float32)[..., :3]
    if srgb:
        a = np.clip(arr, 0.0, None)
        arr = np.where(a < 0.0031308, a * 12.92,
                       1.055 * np.power(np.maximum(a, 1e-10), 1 / 2.4)
                       - 0.055)
    px = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = px.shape[:2]
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          px.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
