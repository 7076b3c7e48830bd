"""Shading-point setup and material dispatch (JAX counterpart:
raytracingproject_tpu/ops/shade.py shader_setup :93, eval_shaders :242,
eval_background :513).

`shader_setup` fetches the hit prims' and objects' wide-table rows and
builds the ShaderData view; `eval_shaders` evaluates every scene shader
over the wavefront and selects per lane; `eval_background` evaluates the
world shader for rays that leave the scene. The ShaderData here carries
the fields the port's nodes and integrator read, the texture coordinates
(uv, generated, the world->generated transform) and the texture store
included; curves, vertex colors and bump data are not part of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from raytracingproject_tpu_torch.models.object import PATH_RAY_CAMERA
from raytracingproject_tpu_torch.ops import closures as cl
from raytracingproject_tpu_torch.ops import lookup as lk
from raytracingproject_tpu_torch.utils import math as um


@dataclass
class ShaderData:
    """Per-lane shading context."""
    P: Any = None            # (N, 3) world hit position
    N: Any = None            # (N, 3) shading normal, faced toward I
    Ng: Any = None           # (N, 3) geometric normal, faced toward I
    Ns: Any = None           # (N, 3) unflipped smooth normal
    I: Any = None            # (N, 3) toward the viewer (-ray dir)
    uv: Any = None           # (N, 2) interpolated texture coordinates
    generated: Any = None    # (N, 3) object-space coords over the bounds
    P_object: Any = None     # (N, 3) object-space position
    time: Any = None
    ray_length: Any = None
    ray_depth: Any = None
    path_flag: Any = None
    prim: Any = None
    shader: Any = None       # (N,) shader slot
    object_index: Any = None
    backfacing: Any = None
    prim_row: Any = None     # fetched prim_table rows (light MIS reuses)
    object_tfm: Any = None   # (N, 3, 4) object -> world
    gen_tfm: Any = None      # (N, 3, 4) world P -> generated coords
    textures: Any = None     # models/image.py TextureStore
    batch_shape: tuple = ()
    device: Any = None


def shader_setup(dscene, hit, ray_o, ray_d, time=None, ray_depth=None,
                 path_flag=None, textures=None):
    """ShaderData for hit lanes (missed lanes carry values the caller
    must keep masked)."""
    n = ray_o.shape[0]
    dev = ray_o.device
    prim = torch.clamp(hit["prim"], min=0)
    obj = torch.clamp(hit["object"], min=0)
    prow = lk.lookup_rows(dscene["prim_table"], prim)
    orow = lk.lookup_rows(dscene["object_table"], obj)
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    vn = prow[:, lk.PT_VN:lk.PT_VN + 9].reshape(n, 3, 3)
    tuv = prow[:, lk.PT_UV:lk.PT_UV + 6].reshape(n, 3, 2)
    shader = prow[:, lk.PT_SHADER].to(torch.int32)
    smooth = prow[:, lk.PT_SMOOTH] > 0.5
    otfm = lk.mat34(orow[:, lk.OT_TFM:lk.OT_TFM + 12])
    oitfm = lk.mat34(orow[:, lk.OT_ITFM:lk.OT_ITFM + 12])

    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = 1.0 - u - v
    Ng_obj = um.triangle_normal(tv[:, 0], tv[:, 1], tv[:, 2])
    Ns_obj = um.safe_normalize(w * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    Ns_obj = torch.where(smooth[:, None], Ns_obj, Ng_obj)
    Ng = um.safe_normalize(um.mat33T_dir(oitfm, Ng_obj))
    Ns = um.safe_normalize(um.mat33T_dir(oitfm, Ns_obj))
    # the exact ray equation for P avoids re-transform rounding
    P = ray_o + hit["t"][:, None] * ray_d
    # texture space is the object's original space, also for geometry
    # baked to world space (OT_ITFM_GEN keeps the pre-merge inverse)
    gen_itfm = lk.mat34(orow[:, lk.OT_ITFM_GEN:lk.OT_ITFM_GEN + 12])
    P_gen = um.mat34_point(gen_itfm, P)
    I = -ray_d
    backfacing = um.dot(Ng, I) < 0.0
    Ngf = torch.where(backfacing[:, None], -Ng, Ng)
    Nf = torch.where(um.dot(Ns, I)[:, None] < 0.0, -Ns, Ns)
    uv = w * tuv[:, 0] + u * tuv[:, 1] + v * tuv[:, 2]
    # generated coords: object-space position over the geometry bounds,
    # and the world -> generated affine map gen = S * (gen_itfm @ P - lo)
    glo = orow[:, lk.OT_BOUNDS_LO:lk.OT_BOUNDS_LO + 3]
    ghi = orow[:, lk.OT_BOUNDS_HI:lk.OT_BOUNDS_HI + 3]
    generated = um.safe_divide(P_gen - glo, torch.clamp(ghi - glo, min=1e-12),
                               0.5)
    inv_ext = 1.0 / torch.clamp(ghi - glo, min=1e-12)
    gen_tfm = torch.cat([gen_itfm[:, :, :3] * inv_ext[:, :, None],
                         ((gen_itfm[:, :, 3] - glo) * inv_ext)[:, :, None]],
                        -1)
    return ShaderData(
        P=P, N=Nf, Ng=Ngf, Ns=Ns, I=I, uv=uv, generated=generated,
        P_object=P_gen,
        time=time if time is not None else torch.zeros(n, device=dev),
        ray_length=hit["t"],
        ray_depth=(ray_depth if ray_depth is not None
                   else torch.zeros(n, dtype=torch.int32, device=dev)),
        path_flag=(path_flag if path_flag is not None
                   else torch.full((n,), PATH_RAY_CAMERA, dtype=torch.int32,
                                   device=dev)),
        prim=hit["prim"], shader=shader, object_index=hit["object"],
        backfacing=backfacing, prim_row=prow, object_tfm=otfm,
        gen_tfm=gen_tfm, textures=textures, batch_shape=(n,), device=dev)


def eval_shaders(shaders, sd, shader_id):
    """Evaluate every scene shader on the wavefront and select per lane
    (masked evaluation, O(num_shaders))."""
    out = cl.empty_closures(sd.batch_shape, sd.device)
    for slot, shader in enumerate(shaders):
        c = shader.evaluate_surface(sd)
        m = shader_id == slot
        for k in out:
            out[k] = torch.where(m[..., None] if out[k].ndim > m.ndim else m,
                                 c[k], out[k])
    return out


def eval_background(shaders, background_shader_slot, ray_d, textures=None,
                    path_flag=None):
    """Background radiance for missed rays (zero without a world
    shader)."""
    n = ray_d.shape[0]
    dev = ray_d.device
    zeros = torch.zeros((n, 3), device=dev)
    if background_shader_slot < 0:
        return zeros
    sd = ShaderData(
        P=zeros, N=-ray_d, Ng=-ray_d, Ns=-ray_d, I=-ray_d,
        uv=torch.zeros((n, 2), device=dev), generated=ray_d, P_object=ray_d,
        time=torch.zeros(n, device=dev),
        ray_length=torch.full((n,), um.RAY_TMAX, device=dev),
        ray_depth=torch.zeros(n, dtype=torch.int32, device=dev),
        path_flag=(path_flag if path_flag is not None
                   else torch.full((n,), PATH_RAY_CAMERA, dtype=torch.int32,
                                   device=dev)),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        shader=torch.full((n,), background_shader_slot, dtype=torch.int32,
                          device=dev),
        object_index=torch.full((n,), -1, dtype=torch.int32, device=dev),
        backfacing=torch.zeros(n, dtype=torch.bool, device=dev),
        textures=textures, batch_shape=(n,), device=dev)
    return shaders[background_shader_slot].evaluate_surface(sd)["emission"]
