"""Homogeneous volume scattering (JAX counterpart:
raytracingproject_tpu/ops/volume.py hg_phase_eval :22, hg_phase_sample
:31, eval_volume_closures :49, sample_distance_homogeneous :69,
distance_pdf :104, equiangular_sample :119, equiangular_pdf :144,
emission_integral :198).

Closed-form distance sampling with throughput-weighted spectral channel
MIS, Henyey-Greenstein phase sampling, equiangular sampling toward a
light point, and the emission integral along a homogeneous segment; the
integrator (ops/integrator.py) runs them over the wavefront. The random
walk of subsurface scattering rides the same functions with its own
medium. Heterogeneous media (ratio and delta tracking) are not ported:
a scene with one raises in the integrator.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.ops import closures as cl
from raytracingproject_tpu_torch.utils import math as um


def hg_phase_eval(cos_theta, g):
    """Henyey-Greenstein phase function value, which equals its pdf."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return (1.0 - g2) / torch.clamp(
        um.M_4PI * denom * torch.sqrt(torch.clamp(denom, min=1e-12)),
        min=1e-12)


def hg_phase_sample(d_in, g, u1, u2):
    """Scattered direction around the incoming direction d_in -> (dir,
    pdf); isotropic for |g| < 1e-3."""
    iso = g.abs() < 1e-3
    safe_g = torch.where(iso, 0.5, g)
    sqr_term = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u1)
    cos_t_hg = (1.0 + safe_g * safe_g - sqr_term * sqr_term) / (2.0 * safe_g)
    cos_t = torch.where(iso, 1.0 - 2.0 * u1, cos_t_hg)
    sin_t = um.safe_sqrt(1.0 - cos_t * cos_t)
    phi = um.M_2PI * u2
    t, b = um.make_orthonormals(d_in)
    dir_out = (sin_t * torch.cos(phi))[..., None] * t \
        + (sin_t * torch.sin(phi))[..., None] * b \
        + cos_t[..., None] * d_in
    return um.safe_normalize(dir_out), hg_phase_eval(cos_t, g)


def eval_volume_closures(shaders, shader_has_volume, vol_shader, n, ctx):
    """Masked dispatch of the volume shaders over the wavefront.
    vol_shader: (N,) slot of the enclosing medium (-1 = vacuum, zeros)."""
    out = cl.empty_volume_closures((n,), ctx.device)
    for slot, shader in enumerate(shaders):
        if not shader_has_volume[slot]:
            continue
        v = shader.evaluate_volume(ctx)
        if v is None:
            continue
        m = vol_shader == slot
        for k in ("sigma_t", "sigma_s", "v_emission"):
            out[k] = torch.where(m[:, None], v[k], out[k])
        out["anisotropy"] = torch.where(m, v["anisotropy"],
                                        out["anisotropy"])
    return out


def _channel_weights(throughput):
    """Channel pick probabilities proportional to |throughput| (uniform
    where it is ~0)."""
    w = throughput.abs()
    wsum = w.sum(-1, keepdim=True)
    return torch.where(wsum > 1e-12, w / torch.clamp(wsum, min=1e-12),
                       torch.full_like(w, 1.0 / 3.0))


def sample_distance_homogeneous(sigma_t, throughput, t_max, u_dist, u_chan):
    """Closed-form scatter distance with spectral channel MIS. Returns
    dict scatter (N,) bool candidate, t_scatter (N,), weight_scatter
    (N, 3) = T / pdf_scatter, weight_pass (N, 3) = T / pdf_pass."""
    w = _channel_weights(throughput)
    c0 = w[..., 0]
    c01 = w[..., 0] + w[..., 1]
    sig_c = torch.where(u_chan < c0, sigma_t[..., 0],
                        torch.where(u_chan < c01, sigma_t[..., 1],
                                    sigma_t[..., 2]))
    sig_c = torch.clamp(sig_c, min=1e-12)
    t_scatter = -torch.log(torch.clamp(1.0 - u_dist, min=1e-12)) / sig_c
    scatter = t_scatter < t_max
    t_eff = torch.minimum(t_scatter, t_max)
    T = torch.exp(-sigma_t * t_eff[..., None])
    pdf_scatter = (w * sigma_t * T).sum(-1)
    pdf_pass = (w * T).sum(-1)
    return {"scatter": scatter, "t_scatter": t_scatter,
            "weight_scatter": um.safe_divide(T, pdf_scatter[..., None], 0.0),
            "weight_pass": um.safe_divide(T, pdf_pass[..., None], 0.0),
            "transmittance": T}


def distance_pdf(sigma_t, throughput, t):
    """Density with which sample_distance_homogeneous scatters at t:
    sum_c w_c sigma_c exp(-sigma_c t)."""
    w = _channel_weights(throughput)
    return (w * sigma_t * torch.exp(-sigma_t * t[..., None])).sum(-1)


def _equiangular_frame(o, d, t_max, light_P):
    to_l = light_P - o
    delta = um.dot(to_l, d)
    D2 = torch.clamp(um.dot(to_l, to_l) - delta * delta, min=0.0)
    D = torch.sqrt(D2)
    theta_a = -torch.atan2(delta, D)
    theta_b = torch.atan2(t_max - delta, D)
    return delta, D2, D, theta_a, theta_b - theta_a


def equiangular_sample(o, d, t_max, light_P, u):
    """Distance on [0, t_max] with pdf ~ 1 / squared distance to
    light_P (Kulla & Fajardo 2012). Returns (t, pdf per unit length,
    valid); valid is False where light_P lies on the ray's axis or the
    span is degenerate."""
    delta, D2, D, theta_a, span = _equiangular_frame(o, d, t_max, light_P)
    t_off = D * torch.tan(theta_a + u * span)
    t = torch.clamp(delta + t_off, 0.0, None)
    t = torch.minimum(t, t_max)
    pdf = um.safe_divide(D, span * (D2 + t_off * t_off), 0.0)
    valid = (D > 1e-6) & (span > 1e-6) & (t_max > 1e-8)
    return t, pdf, valid


def equiangular_pdf(o, d, t_max, light_P, t):
    """Density of equiangular_sample at a given t (zero where it is
    invalid)."""
    delta, D2, D, _theta_a, span = _equiangular_frame(o, d, t_max, light_P)
    t_off = t - delta
    pdf = um.safe_divide(D, span * (D2 + t_off * t_off), 0.0)
    return torch.where((D > 1e-6) & (span > 1e-6), pdf, 0.0)


def emission_integral(v_emission, sigma_t, t):
    """int_0^t e exp(-sigma_t s) ds along a homogeneous segment."""
    st = torch.clamp(sigma_t, min=1e-12)
    return v_emission * (1.0 - torch.exp(-sigma_t * t[..., None])) / st
