"""Shader nodes of the port and their torch evals (JAX counterpart:
raytracingproject_tpu/models/shader_nodes.py; SubsurfaceScatteringNode
:334, PrincipledVolumeNode :499, ImageTextureNode :924,
CheckerTextureNode :1013).

`EVALS` is the registry: node class -> eval(node, ctx, inp) returning
{output_name: value}. The port grows it node by node; `eval_node`
raises NotImplementedError for any class not yet in it.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch.models.node import SocketType as S
from raytracingproject_tpu_torch.models.shader import ShaderNode
from raytracingproject_tpu_torch.ops import closures as cl
from raytracingproject_tpu_torch.ops import texture as tex


def _bf(ctx, v):
    """Float input -> (N,) float32."""
    if isinstance(v, (float, int)):
        return torch.full(ctx.batch_shape, float(v), device=ctx.device)
    v = torch.as_tensor(v, dtype=torch.float32, device=ctx.device)
    if v.ndim > len(ctx.batch_shape):  # a color linked into a float socket
        return torch.mean(v, dim=-1)
    return v.expand(ctx.batch_shape)


def _bc(ctx, v):
    """Color input -> (N, 3) float32."""
    v = torch.as_tensor(v, dtype=torch.float32, device=ctx.device)
    if v.ndim and v.shape[-1] == 3 and tuple(v.shape) != ctx.batch_shape:
        return v.expand(ctx.batch_shape + (3,))
    if v.ndim == 0:
        return torch.full(ctx.batch_shape + (3,), float(v),
                          device=ctx.device)
    return v[..., None].expand(ctx.batch_shape + (3,))


class DiffuseBsdfNode(ShaderNode):
    INPUTS = [("color", "color", (0.8, 0.8, 0.8)),
              ("roughness", "float", 0.0),
              ("normal", "normal", (0.0, 0.0, 0.0))]
    OUTPUTS = [("bsdf", "closure")]


class GlossyBsdfNode(ShaderNode):
    INPUTS = [("color", "color", (0.8, 0.8, 0.8)),
              ("roughness", "float", 0.2),
              ("normal", "normal", (0.0, 0.0, 0.0))]
    OUTPUTS = [("bsdf", "closure")]
    PARAMS = [S("distribution", S.ENUM, "ggx",
                {"sharp": 0, "beckmann": 1, "ggx": 2, "multi_ggx": 3,
                 "ashikhmin_shirley": 4})]


class EmissionNode(ShaderNode):
    INPUTS = [("color", "color", (0.8, 0.8, 0.8)),
              ("strength", "float", 1.0)]
    OUTPUTS = [("emission", "closure")]


class BackgroundNode(ShaderNode):
    INPUTS = [("color", "color", (0.8, 0.8, 0.8)),
              ("strength", "float", 1.0)]
    OUTPUTS = [("background", "closure")]


class SubsurfaceScatteringNode(ShaderNode):
    INPUTS = [("color", "color", (0.8, 0.8, 0.8)),
              ("scale", "float", 0.01),
              ("radius", "vector", (0.1, 0.1, 0.1)),
              ("normal", "normal", (0.0, 0.0, 0.0))]
    OUTPUTS = [("bssrdf", "closure")]
    PARAMS = [S("falloff", S.ENUM, "random_walk",
                {"burley": 0, "random_walk": 1})]


class PrincipledVolumeNode(ShaderNode):
    INPUTS = [("color", "color", (0.5, 0.5, 0.5)),
              ("density", "float", 1.0),
              ("anisotropy", "float", 0.0),
              ("absorption_color", "color", (0.0, 0.0, 0.0)),
              ("emission_strength", "float", 0.0),
              ("emission_color", "color", (1.0, 1.0, 1.0))]
    OUTPUTS = [("volume", "closure")]


class ImageTextureNode(ShaderNode):
    """`slot` is bound by the scene's ImageManager at compile; `image`
    holds the (H, W, C) array."""
    INPUTS = [("vector", "vector", (0.0, 0.0, 0.0))]
    OUTPUTS = [("color", "color"), ("alpha", "float")]
    PARAMS = [S("filename", S.STRING, ""),
              S("interpolation", S.ENUM, "linear",
                {"closest": tex.INTERPOLATION_CLOSEST,
                 "linear": tex.INTERPOLATION_LINEAR}),
              S("extension", S.ENUM, "repeat",
                {"repeat": tex.EXTENSION_REPEAT,
                 "extend": tex.EXTENSION_EXTEND,
                 "clip": tex.EXTENSION_CLIP}),
              S("use_auto_mip", S.BOOLEAN, False)]

    def __init__(self, name="", image=None, **kwargs):
        super().__init__(name, **kwargs)
        self.image = image
        self.slot = -1


class CheckerTextureNode(ShaderNode):
    INPUTS = [("vector", "vector", (0.0, 0.0, 0.0)),
              ("color1", "color", (0.8, 0.8, 0.8)),
              ("color2", "color", (0.2, 0.2, 0.2)),
              ("scale", "float", 1.0)]
    OUTPUTS = [("color", "color"), ("fac", "float")]


def _mod(x, y):
    """Floor modulo as numpy and JAX compute it: the exact truncated
    remainder, moved into the divisor's sign (torch.remainder rounds
    x - y * floor(x / y) instead)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _unlinked(v):
    return v is None or (isinstance(v, np.ndarray) and not v.any())


def _eval_image_texture(node, ctx, inp):
    if not _unlinked(inp["vector"]):
        raise NotImplementedError("a linked image-texture vector is not "
                                  "ported")
    if node.use_auto_mip:
        raise NotImplementedError("auto-mip image textures are not ported")
    u, v = ctx.uv[..., 0], ctx.uv[..., 1]
    data, h, w = ctx.textures.get(node.slot)
    rgba = tex.sample_image(data, h, w, u, v,
                            node.get_enum_int("interpolation"),
                            node.get_enum_int("extension"))
    return {"color": rgba[..., :3], "alpha": rgba[..., 3]}


def _eval_checker(node, ctx, inp):
    """Checker over the generated coordinates, box-filtered over the
    shading footprint (ray length x the camera's pixel angle, through the
    world -> generated Jacobian): the mean of the +-1 square wave over a
    box factorises per axis into differences of its triangle-wave
    antiderivative G. Point-sampled where no footprint is known."""
    if not _unlinked(inp["vector"]):
        raise NotImplementedError("a linked checker vector is not ported")
    scale = _bf(ctx, inp["scale"])
    p = ctx.generated * scale[..., None] + 1e-5  # off the integer seams
    pixel_angle = getattr(ctx.textures, "pixel_angle", None)
    fw = None
    if ctx.ray_length is not None and ctx.gen_tfm is not None \
            and pixel_angle:
        fp_world = ctx.ray_length * float(np.float32(pixel_angle))
        jac = torch.sqrt(torch.sum(ctx.gen_tfm[..., :3] ** 2, dim=-1))
        fw = scale.abs()[..., None] * fp_world[..., None] * jac
    c1 = _bc(ctx, inp["color1"])
    c2 = _bc(ctx, inp["color2"])
    if fw is None:
        idx = torch.floor(p).to(torch.int32)
        check = ((idx[..., 0] + idx[..., 1] + idx[..., 2]) & 1) == 0
        prob = check.to(torch.float32)
    else:
        def G(t):
            return 1.0 - (_mod(t, 2.0) - 1.0).abs()

        wd = torch.clamp(fw, min=1e-4)
        avg = (G(p + 0.5 * wd) - G(p - 0.5 * wd)) / wd
        prob = 0.5 + 0.5 * avg[..., 0] * avg[..., 1] * avg[..., 2]
    return {"color": prob[..., None] * c1 + (1.0 - prob[..., None]) * c2,
            "fac": prob}


def _check_normal(inp):
    n = inp.get("normal")
    if n is not None and (not isinstance(n, np.ndarray) or n.any()):
        raise NotImplementedError("custom shading normals are not ported")


def _eval_diffuse(node, ctx, inp):
    _check_normal(inp)
    r = inp["roughness"]
    if not isinstance(r, float) or r != 0.0:
        raise NotImplementedError("Oren-Nayar diffuse roughness is not ported")
    c = cl.empty_closures(ctx.batch_shape, ctx.device)
    c["diffuse"] = _bc(ctx, inp["color"])
    return {"bsdf": c}


def _eval_glossy(node, ctx, inp):
    _check_normal(inp)
    dist = node.get_enum_int("distribution")
    if dist == 3:
        raise NotImplementedError("multiscatter GGX is not ported")
    c = cl.empty_closures(ctx.batch_shape, ctx.device)
    c["glossy"] = _bc(ctx, inp["color"])
    rough = _bf(ctx, inp["roughness"])
    if dist == 0:  # sharp
        rough = torch.zeros_like(rough)
    c["glossy_roughness"] = rough
    return {"bsdf": c}


def _eval_emission(node, ctx, inp):
    c = cl.empty_closures(ctx.batch_shape, ctx.device)
    c["emission"] = _bc(ctx, inp["color"]) \
        * _bf(ctx, inp["strength"])[..., None]
    return {"emission": c}


def _eval_background(node, ctx, inp):
    c = cl.empty_closures(ctx.batch_shape, ctx.device)
    c["emission"] = _bc(ctx, inp["color"]) \
        * _bf(ctx, inp["strength"])[..., None]
    return {"background": c}


def _eval_subsurface(node, ctx, inp):
    _check_normal(inp)
    c = cl.empty_closures(ctx.batch_shape, ctx.device)
    c["subsurface"] = _bc(ctx, inp["color"])
    c["subsurface_radius"] = _bc(ctx, inp["radius"]) \
        * _bf(ctx, inp["scale"])[..., None]
    if node.get_enum_int("falloff") == 0:  # burley
        c["subsurface_burley"] = torch.ones(ctx.batch_shape,
                                            device=ctx.device)
    return {"bssrdf": c}


def _eval_principled_volume(node, ctx, inp):
    v = cl.empty_volume_closures(ctx.batch_shape, ctx.device)
    density = torch.clamp(_bf(ctx, inp["density"]), min=0.0)[..., None]
    sigma_s = _bc(ctx, inp["color"]) * density
    sigma_a = torch.clamp(1.0 - _bc(ctx, inp["absorption_color"]),
                          min=0.0) * density
    v["sigma_s"] = sigma_s
    v["sigma_t"] = sigma_s + sigma_a
    v["anisotropy"] = _bf(ctx, inp["anisotropy"])
    v["v_emission"] = _bc(ctx, inp["emission_color"]) \
        * _bf(ctx, inp["emission_strength"])[..., None]
    return {"volume": v}


EVALS = {
    DiffuseBsdfNode: _eval_diffuse,
    GlossyBsdfNode: _eval_glossy,
    EmissionNode: _eval_emission,
    BackgroundNode: _eval_background,
    SubsurfaceScatteringNode: _eval_subsurface,
    PrincipledVolumeNode: _eval_principled_volume,
    ImageTextureNode: _eval_image_texture,
    CheckerTextureNode: _eval_checker,
}

# class name -> port class, for graphs converted from the JAX package
NODE_CLASSES = {cls.__name__: cls for cls in EVALS}


def eval_node(node, ctx, inp):
    fn = EVALS.get(type(node))
    if fn is None:
        raise NotImplementedError(
            f"shader node {type(node).__name__} is not ported")
    return fn(node, ctx, inp)
