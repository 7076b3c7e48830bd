"""K1: the dense sweep, every ray against every triangle (JAX
counterpart: raytracingproject_tpu/ops/pallas_intersect.py
intersect_brute_pallas, and the dense functions of ops/intersect.py that
the JAX integrator calls on scenes of at most 1,024 static prims).

Four wrappers over csrc/dense_sweep.cu, each with its plain version in
ops/intersect.py and the same signature and returns:

- `intersect_brute_sweep`   closest hit       plain: intersect_brute
- `shadow_blocked_sweep`    any hit           plain: shadow_blocked_brute
- `occlusion_sweep`         the dual form     plain: intersect_brute_occlusion
- `intersect_mt_sweep`      the TPU kernel's Moeller-Trumbore contract
                                              plain: intersect_brute_mt

The first three are what the integrator's use_brute dispatch calls; no
render calls the fourth, in either package. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Deform motion
(tri_verts_t1, time) is not ported and raises. `launches` counts kernel
launches per mode.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import intersect as isect

launches = {"closest": 0, "any": 0, "dual": 0, "mt": 0}

_F, _I, _B = torch.float32, torch.int32, torch.bool


def _no_deform(tri_verts_t1, time):
    if tri_verts_t1 is not None or time is not None:
        raise NotImplementedError(
            "deform motion in the dense sweep is not ported")


def _check(tensors, n=None):
    """tensors: (name, tensor, dtype, shape) rows; shape None skips it."""
    req = kernels.require
    for name, x, dtype, shape in tensors:
        req(x.device.type == "cuda", f"{name} must be a CUDA tensor")
        req(x.is_contiguous(), f"{name} must be contiguous")
        req(x.dtype == dtype, f"{name}: wrong dtype {x.dtype}")
        if shape is not None:
            req(tuple(x.shape) == shape,
                f"{name}: shape {tuple(x.shape)}, expected {shape}")


def _tri_rows(tri_verts, prim_object, object_visibility):
    p = tri_verts.shape[0]
    kernels.require(p > 0, "the dense sweep needs at least one triangle")
    rows = [("tri_verts", tri_verts, _F, (p, 3, 3)),
            ("prim_object", prim_object, _I, (p,))]
    if object_visibility is not None:
        rows.append(("object_visibility", object_visibility, _I, None))
    return p, rows


def _ray_rows(o, d, **lanes):
    n = o.shape[0]
    return n, [("o", o, _F, (n, 3)), ("d", d, _F, (n, 3))] + [
        (k, x, _I if k.startswith("vis") else _F, (n,))
        for k, x in lanes.items() if x is not None]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(mode, fn_name, *args):
    rc = getattr(kernels.load(), fn_name)(*args, kernels.current_stream())
    kernels.check_rc(f"dense_sweep {mode}", rc)
    launches[mode] += 1


def intersect_brute_sweep(tri_verts, prim_object, o, d, tmin, tmax,
                          visibility=None, object_visibility=None,
                          tri_verts_t1=None, time=None):
    """Dense closest hit; returns dict t, u, v (f32), prim, object (int32)
    as ops/intersect.py intersect_brute."""
    _no_deform(tri_verts_t1, time)
    if o.device.type == "cpu":
        return isect.intersect_brute(tri_verts, prim_object, o, d, tmin,
                                     tmax, visibility, object_visibility)
    if visibility is None or object_visibility is None:
        visibility = object_visibility = None
    p, rows = _tri_rows(tri_verts, prim_object, object_visibility)
    n, rays = _ray_rows(o, d, tmin=tmin, tmax=tmax, visibility=visibility)
    _check(rows + rays)
    dev = o.device
    out = {"t": torch.empty(n, dtype=_F, device=dev),
           "prim": torch.empty(n, dtype=_I, device=dev),
           "u": torch.empty(n, dtype=_F, device=dev),
           "v": torch.empty(n, dtype=_F, device=dev),
           "object": torch.empty(n, dtype=_I, device=dev)}
    _launch("closest", "rt_dense_closest", tri_verts.data_ptr(),
            prim_object.data_ptr(), _ptr(object_visibility), p, o.data_ptr(),
            d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), _ptr(visibility),
            n, *(x.data_ptr() for x in out.values()))
    return out


def shadow_blocked_sweep(tri_verts, prim_object, o, d, tmin, tmax,
                         visibility=None, object_visibility=None,
                         tri_verts_t1=None, time=None):
    """Dense any hit: (N,) bool, as ops/intersect.py shadow_blocked_brute."""
    _no_deform(tri_verts_t1, time)
    if o.device.type == "cpu":
        return isect.shadow_blocked_brute(tri_verts, prim_object, o, d, tmin,
                                          tmax, visibility, object_visibility)
    if visibility is None or object_visibility is None:
        visibility = object_visibility = None
    p, rows = _tri_rows(tri_verts, prim_object, object_visibility)
    n, rays = _ray_rows(o, d, tmin=tmin, tmax=tmax, visibility=visibility)
    _check(rows + rays)
    blocked = torch.empty(n, dtype=_B, device=o.device)
    _launch("any", "rt_dense_any", tri_verts.data_ptr(),
            prim_object.data_ptr(), _ptr(object_visibility), p, o.data_ptr(),
            d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), _ptr(visibility),
            n, blocked.data_ptr())
    return blocked


def occlusion_sweep(tri_verts, prim_object, boundary_mask, o, d, tmin,
                    tmax_closest, tmax_any, visibility_closest,
                    visibility_any, object_visibility, tri_verts_t1=None,
                    time=None):
    """The volume NEE's dual form: (t_boundary, t_other, blocked), as
    ops/intersect.py intersect_brute_occlusion."""
    _no_deform(tri_verts_t1, time)
    if o.device.type == "cpu":
        return isect.intersect_brute_occlusion(
            tri_verts, prim_object, boundary_mask, o, d, tmin, tmax_closest,
            tmax_any, visibility_closest, visibility_any, object_visibility)
    p, rows = _tri_rows(tri_verts, prim_object, object_visibility)
    rows.append(("boundary_mask", boundary_mask, _B, (p,)))
    n, rays = _ray_rows(o, d, tmin=tmin, tmax_closest=tmax_closest,
                        tmax_any=tmax_any,
                        visibility_closest=visibility_closest,
                        visibility_any=visibility_any)
    _check(rows + rays)
    dev = o.device
    t_b = torch.empty(n, dtype=_F, device=dev)
    t_o = torch.empty(n, dtype=_F, device=dev)
    blocked = torch.empty(n, dtype=_B, device=dev)
    _launch("dual", "rt_dense_dual", tri_verts.data_ptr(),
            prim_object.data_ptr(), object_visibility.data_ptr(),
            boundary_mask.data_ptr(), p, o.data_ptr(), d.data_ptr(),
            tmin.data_ptr(), tmax_closest.data_ptr(), tmax_any.data_ptr(),
            visibility_closest.data_ptr(), visibility_any.data_ptr(), n,
            t_b.data_ptr(), t_o.data_ptr(), blocked.data_ptr())
    return t_b, t_o, blocked


def intersect_mt_sweep(tri_v0, tri_e1, tri_e2, o, d, tmin, tmax):
    """Dense closest hit in the TPU kernel's Moeller-Trumbore arithmetic
    on (nb, 8, 3) triangle packets; returns dict t, prim, u, v as
    ops/intersect.py intersect_brute_mt."""
    if o.device.type == "cpu":
        return isect.intersect_brute_mt(tri_v0, tri_e1, tri_e2, o, d, tmin,
                                        tmax)
    nb = tri_v0.shape[0]
    kernels.require(nb > 0, "the dense sweep needs at least one packet")
    shape = (nb, isect.TRI_BLOCK, 3)
    n, rays = _ray_rows(o, d, tmin=tmin, tmax=tmax)
    _check([("tri_v0", tri_v0, _F, shape), ("tri_e1", tri_e1, _F, shape),
            ("tri_e2", tri_e2, _F, shape)] + rays)
    dev = o.device
    out = {"t": torch.empty(n, dtype=_F, device=dev),
           "prim": torch.empty(n, dtype=_I, device=dev),
           "u": torch.empty(n, dtype=_F, device=dev),
           "v": torch.empty(n, dtype=_F, device=dev)}
    _launch("mt", "rt_dense_mt", tri_v0.data_ptr(), tri_e1.data_ptr(),
            tri_e2.data_ptr(), nb * isect.TRI_BLOCK, o.data_ptr(),
            d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
            *(x.data_ptr() for x in out.values()))
    return out
