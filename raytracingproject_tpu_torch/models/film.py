"""Film settings and the pixel-filter table (JAX counterpart:
raytracingproject_tpu/models/film.py). Render passes beyond the combined
image are not part of this slice."""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.models.node import Node, SocketType as S

FILTER_BOX = 0
FILTER_GAUSSIAN = 1
FILTER_BLACKMAN_HARRIS = 2
FILTER_TABLE_SIZE = 128


class Film(Node):
    SOCKETS = [
        S("exposure", S.FLOAT, 1.0),
        S("filter_type", S.ENUM, "blackman_harris",
          {"box": FILTER_BOX, "gaussian": FILTER_GAUSSIAN,
           "blackman_harris": FILTER_BLACKMAN_HARRIS}),
        S("filter_width", S.FLOAT, 1.5),
        # render adaptively (session/session.py render) even at threshold 0
        S("use_adaptive_sampling", S.BOOLEAN, False),
    ]

    def filter_function(self, x, width):
        ft = self.get_enum_int("filter_type")
        if ft == FILTER_BOX:
            return np.ones_like(x)
        if ft == FILTER_GAUSSIAN:
            alpha = 9.0 / (width * width)
            return np.maximum(
                np.exp(-alpha * x * x)
                - np.exp(-alpha * width * width * 0.25), 0.0)
        t = (x + width * 0.5) / width * (2 * np.pi)
        return (0.35875 - 0.48829 * np.cos(t) + 0.14128 * np.cos(2 * t)
                - 0.01168 * np.cos(3 * t))

    def build_filter_table(self):
        """Inverted-CDF table: u in [0,1) -> subpixel offset in
        [-width/2, width/2], importance-sampling the filter."""
        width = float(self.filter_width)
        n = FILTER_TABLE_SIZE
        x = (np.arange(n) + 0.5) / n * width - width * 0.5
        f = np.maximum(self.filter_function(x, width), 0.0)
        cdf = np.concatenate([[0.0], np.cumsum(f)])
        cdf /= cdf[-1]
        u = np.arange(n, dtype=np.float64) / (n - 1)
        inv = np.interp(u, cdf, np.linspace(-width * 0.5, width * 0.5, n + 1))
        return inv.astype(np.float32)
