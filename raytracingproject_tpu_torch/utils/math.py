"""Vector math over batched (..., 3) tensors (JAX counterpart:
raytracingproject_tpu/utils/math.py).

Every helper takes tensors whose last axis is the vector axis. Products
and sums are written out component by component, in the same order as
the JAX package, so both frameworks round the same way; per-lane
geometry never goes through `@` (see mat34_point).
"""

from __future__ import annotations

import torch

M_PI = 3.14159265358979323846
M_2PI = 2.0 * M_PI
M_4PI = 4.0 * M_PI
M_1_PI = 1.0 / M_PI

# Large-but-finite ray distance (fp32 safe).
RAY_TMAX = 1e30


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=1e-38))[..., None]


def safe_normalize(a):
    """Normalize; returns the input unchanged for (near-)zero vectors."""
    t = dot(a, a)[..., None]
    return torch.where(t > 1e-38, a * torch.rsqrt(torch.clamp(t, min=1e-38)),
                       a)


def safe_divide(a, b, fallback=0.0):
    return torch.where(b != 0.0, a / torch.where(b == 0.0, 1.0, b),
                       fallback)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def power_heuristic(a, b):
    """MIS power heuristic (beta = 2)."""
    t = a * a
    return safe_divide(t, t + b * b, 0.0)


# --- exact small-matrix transforms -----------------------------------
# A batched tiny `@` runs at reduced precision on some devices (bf16
# passes on the TPU MXU, TF32 on tensor cores); geometry transforms use
# explicit component math instead.

def mat34_point(m, p):
    """(..., 3, 4) affine transform applied to points (..., 3)."""
    return torch.stack(
        [m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1]
         + m[..., i, 2] * p[..., 2] + m[..., i, 3] for i in range(3)], -1)


def mat34_dir(m, d):
    """(..., 3, 4) (or (..., 3, 3)) rotation part applied to vectors."""
    return torch.stack(
        [m[..., i, 0] * d[..., 0] + m[..., i, 1] * d[..., 1]
         + m[..., i, 2] * d[..., 2] for i in range(3)], -1)


def mat33T_dir(m, n):
    """Transpose of the 3x3 part applied to vectors (normal transform:
    pass the inverse matrix)."""
    return torch.stack(
        [m[..., 0, i] * n[..., 0] + m[..., 1, i] * n[..., 1]
         + m[..., 2, i] * n[..., 2] for i in range(3)], -1)


def make_orthonormals(n):
    """Branch-free (t, b) tangent frame for unit normal n (Duff et al.)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt


def to_local(v, t, b, n):
    """World direction -> tangent-space (t, b, n) coordinates."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)


def from_local(v, t, b, n):
    """Tangent-space direction -> world."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def sample_cos_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere sample around n -> (dir, pdf)."""
    r = torch.sqrt(u1)
    phi = M_2PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = safe_sqrt(1.0 - u1)
    t, b = make_orthonormals(n)
    d = x[..., None] * t + y[..., None] * b + z[..., None] * n
    return d, z * M_1_PI


def sample_uniform_sphere(u1, u2):
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = M_2PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def concentric_sample_disk(u1, u2):
    """Concentric (Shirley) map of the unit square onto the unit disk ->
    (x, y). Branch-free."""
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    use_a = a.abs() > b.abs()
    r = torch.where(use_a, a, b)
    safe = torch.where(use_a, torch.where(a == 0.0, 1.0, a),
                       torch.where(b == 0.0, 1.0, b))
    phi = torch.where(use_a, (M_PI / 4.0) * (b / safe),
                      (M_PI / 2.0) - (M_PI / 4.0) * (a / safe))
    r = torch.where((a == 0.0) & (b == 0.0), 0.0, r)
    return r * torch.cos(phi), r * torch.sin(phi)


def regular_polygon_sample(corners, rotation, u1, u2):
    """Uniform point in a regular polygon of `corners` sides inscribed in
    the unit circle (the aperture's blades) -> (x, y): u1 picks the
    side's triangle of the fan, (u, v) folds onto that triangle."""
    u = u1 * corners
    side = torch.floor(u)
    u = u - side
    v = u2
    flip = u + v > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    angle0 = (side / corners) * M_2PI + rotation
    angle1 = ((side + 1.0) / corners) * M_2PI + rotation
    return (u * torch.cos(angle0) + v * torch.cos(angle1),
            u * torch.sin(angle0) + v * torch.sin(angle1))


def triangle_area(v0, v1, v2):
    return 0.5 * length(cross(v1 - v0, v2 - v0))


def triangle_normal(v0, v1, v2):
    return safe_normalize(cross(v1 - v0, v2 - v0))
