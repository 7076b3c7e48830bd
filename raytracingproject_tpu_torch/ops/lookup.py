"""Wide-table layouts and lookups (JAX counterpart:
raytracingproject_tpu/ops/lookup.py).

The scene packs per-primitive and per-object attributes into one wide
float32 table each. On the TPU a row fetch needs select chains or
one-hot matmuls; on the GPU it is a plain gather, `table[idx]`.
"""

from __future__ import annotations

import torch

ONEHOT_MAX_ROWS = 512

# prim_table column layout
PT_V0 = 0          # 0:9   v0, v1, v2
PT_VN = 9          # 9:18  per-corner normals
PT_UV = 18         # 18:24 per-corner uvs
PT_SHADER = 24
PT_SMOOTH = 25
PT_EMISSION = 26   # 26:29
PT_LIGHT_PMF = 29
PT_OBJECT = 30
PT_TANGENT = 31    # 31:34
PT_CURVE = 34
PT_LT_LEAF = 35
PT_COLS = 36

# object_table column layout
OT_TFM = 0         # 0:12
OT_ITFM = 12       # 12:24
OT_ITFM_GEN = 24   # 24:36
OT_COLOR = 36      # 36:39
OT_RANDOM = 39
OT_BOUNDS_LO = 40  # 40:43
OT_BOUNDS_HI = 43  # 43:46
OT_VISIBILITY = 46
OT_FLAGS = 47
OT_PARTICLE = 48   # 48:62
OT_COLS = 62

# lamp_table column layout
LT_TYPE = 0
LT_CO = 1          # 1:4
LT_DIR = 4         # 4:7
LT_SIZE = 7
LT_AXISU = 8       # 8:11
LT_AXISV = 11      # 11:14
LT_SIZEU = 14
LT_SIZEV = 15
LT_STRENGTH = 16   # 16:19
LT_ANGLE = 19
LT_SPOT_ANGLE = 20
LT_SPOT_SMOOTH = 21
LT_PMF = 22
LT_IES = 23        # > 0: row index + 1 of an IES grid (not ported)
LT_COLS = 24


def lookup_rows(table, idx):
    """Fetch rows `idx` (any shape) from `table` (P, C) -> (*idx, C)."""
    return table[idx.long()]


def searchsorted_cdf(cdf, u):
    """Index of the CDF interval containing u; cdf is (D+1,) ascending
    with cdf[0] = 0 and cdf[-1] = 1. Counts interior boundaries <= u, as
    the JAX package does for small D."""
    d = cdf.shape[0] - 1
    if d <= 1:
        return torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    return (u[..., None] >= cdf[1:-1]).sum(-1)


def mat34(flat):
    """(N, 12) -> (N, 3, 4)."""
    return flat.reshape(flat.shape[:-1] + (3, 4))
