"""Affine transforms as 3x4 matrices (JAX counterpart:
raytracingproject_tpu/utils/transform.py).

Host side, in NumPy: what the scene compile needs, construction
(identity, translation, rotation), composition, inversion, look-at, point
transforms and the motion decomposition the camera record carries. Same
NumPy operations in the same order as the JAX package, so the compiled
scene tables come out bit-identical.

Per lane, in torch: the camera's motion path, a decomposed transform
interpolated at each lane's shutter time (quat_to_matrix,
motion_interpolate, motion_interpolate_steps). Products are written out
by components, never through `@` (see utils/math.py mat34_point).
"""

from __future__ import annotations

import numpy as np
import torch

IDENTITY = np.array([[1, 0, 0, 0],
                     [0, 1, 0, 0],
                     [0, 0, 1, 0]], dtype=np.float32)


def identity():
    return IDENTITY.copy()


def to_4x4(t):
    m = np.eye(4, dtype=np.float64)
    m[:3] = np.asarray(t, np.float64)
    return m


def translate(x, y=None, z=None):
    if y is None:
        x, y, z = x
    t = identity()
    t[:, 3] = (x, y, z)
    return t


def rotate(angle, axis):
    """Rotation by `angle` radians about `axis`."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        return identity()
    x, y, z = axis / n
    s, c = np.sin(angle), np.cos(angle)
    t = 1.0 - c
    return np.array([
        [x * x * t + c, x * y * t - z * s, x * z * t + y * s, 0.0],
        [y * x * t + z * s, y * y * t + c, y * z * t - x * s, 0.0],
        [z * x * t - y * s, z * y * t + x * s, z * z * t + c, 0.0],
    ], dtype=np.float32)


def compose(a, b):
    """Return the transform applying b first, then a (a @ b)."""
    return (to_4x4(a) @ to_4x4(b))[:3].astype(np.float32)


def inverse(t):
    """Invert a 3x4 affine transform."""
    return np.linalg.inv(to_4x4(t))[:3].astype(np.float32)


def look_at(position, look, up):
    """Camera look-at matrix (camera looks down +z with y up)."""
    position = np.asarray(position, np.float64)
    direction = np.asarray(look, np.float64) - position
    direction /= max(np.linalg.norm(direction), 1e-12)
    up = np.asarray(up, np.float64)
    right = np.cross(direction, up)
    nr = np.linalg.norm(right)
    if nr < 1e-9:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= nr
    new_up = np.cross(right, direction)
    m = np.stack([right, new_up, direction, position], axis=1)
    return m.astype(np.float32)


def transform_point(t, p):
    """Apply a (3, 4) transform to (..., 3) points (component math)."""
    return np.stack(
        [t[..., i, 0] * p[..., 0] + t[..., i, 1] * p[..., 1]
         + t[..., i, 2] * p[..., 2] + t[..., i, 3] for i in range(3)], -1)


def matrix_to_quat(m):
    """Rotation 3x3 -> quaternion (w, x, y, z)."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0.0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z])


def decompose(t):
    """3x4 -> flat float32[16] record (quat[4], translation[3],
    scale/shear 3x3[9]) via a polar decomposition."""
    t = np.asarray(t, np.float64)
    u, s, vt = np.linalg.svd(t[:3, :3])
    r = u @ vt
    if np.linalg.det(r) < 0.0:
        u[:, -1] = -u[:, -1]
        s[-1] = -s[-1]
        r = u @ vt
    scale_m = vt.T @ np.diag(s) @ vt
    out = np.zeros(16, np.float32)
    out[0:4] = matrix_to_quat(r)
    out[4:7] = t[:3, 3]
    out[7:16] = scale_m.reshape(-1)
    return out


def quat_to_matrix(q):
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], -1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], -1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], -2)


def _dot4(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2] + a[..., 3] * b[..., 3])[..., None]


def motion_interpolate(decomp_a, decomp_b, t):
    """Two decomposed transforms (flat 16-float records of `decompose`)
    interpolated at times t in [0, 1] -> (..., 3, 4): the rotation by
    slerp (nlerp where the quaternions are nearly parallel), translation
    and scale linearly."""
    qa, qb = decomp_a[..., 0:4], decomp_b[..., 0:4]
    d = _dot4(qa, qb)
    qb = torch.where(d < 0.0, -qb, qb)
    d = d.abs()
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_slerp = sin_theta > 1e-5
    # the division only where it is taken: no lane divides by zero
    safe_sin = torch.where(use_slerp, sin_theta, 1.0)
    tt = t[..., None]
    wa = torch.where(use_slerp, torch.sin((1.0 - tt) * theta) / safe_sin,
                     1.0 - tt)
    wb = torch.where(use_slerp, torch.sin(tt * theta) / safe_sin, tt)
    q = wa * qa + wb * qb
    q = q / torch.clamp(torch.sqrt(_dot4(q, q)), min=1e-12)
    trans = (1.0 - tt) * decomp_a[..., 4:7] + tt * decomp_b[..., 4:7]
    sm = (1.0 - tt) * decomp_a[..., 7:16] + tt * decomp_b[..., 7:16]
    sm = sm.reshape(sm.shape[:-1] + (3, 3))
    rot = quat_to_matrix(q)
    m = torch.stack([torch.stack(
        [rot[..., i, 0] * sm[..., 0, j] + rot[..., i, 1] * sm[..., 1, j]
         + rot[..., i, 2] * sm[..., 2, j] for j in range(3)], -1)
        for i in range(3)], -2)
    return torch.cat([m, trans[..., None]], -1)


def motion_interpolate_steps(decomps, time, steps):
    """Piecewise interpolation over `steps` decomposed transforms packed
    in one (..., steps * 16) record: each lane picks its segment by a
    select chain, then interpolates inside it. steps == 2 is
    motion_interpolate."""
    if steps == 2:
        return motion_interpolate(decomps[..., 0:16], decomps[..., 16:32],
                                  time)
    s1 = steps - 1
    tt = time * s1
    j = torch.clamp(torch.floor(tt), 0.0, float(s1 - 1))
    frac = tt - j
    da = torch.zeros(decomps.shape[:-1] + (16,), dtype=decomps.dtype,
                     device=decomps.device)
    db = da
    for k in range(s1):
        sel = (j == k)[..., None]
        da = torch.where(sel, decomps[..., 16 * k:16 * k + 16], da)
        db = torch.where(sel, decomps[..., 16 * (k + 1):16 * (k + 2)], db)
    return motion_interpolate(da, db, frac)
