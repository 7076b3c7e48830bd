"""BSDF evaluation and sampling over the closure union (JAX counterpart:
raytracingproject_tpu/ops/bsdf.py bsdf_eval :440, bsdf_sample :604,
_sample_ggx_vndf :53, _ggx_reflect_eval :256, _lobe_probs :398).

Lobes of the port: Lambert diffuse, GGX reflection with VNDF sampling
(sharp GGX becomes a delta lobe) and the transparent pass-through (a
delta lobe). Sampling picks a lobe in proportion to its mean weight,
samples it, then evaluates the whole stack at the sampled direction: the
mixture pdf MIS needs. The subsurface closure folds into the diffuse lobe
unless the scene has the random-walk integrator (feature has_subsurface),
which then takes the subsurface lobe itself. Directions follow the Cycles
convention (I toward the viewer, omega_in toward the light). Scene
features that need other lobes raise NotImplementedError.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.utils import math as um

LABEL_DIFFUSE = 1
LABEL_GLOSSY = 2
LABEL_TRANSMIT = 4
LABEL_SINGULAR = 8
LABEL_TRANSPARENT = 16
LABEL_VOLUME_SCATTER = 32

SHARP_ROUGHNESS = 1e-4  # below this a lobe is a delta

# scene features with lobes outside this slice
_UNPORTED_FEATURES = ("has_refraction", "has_diffuse_roughness",
                      "has_multiscatter", "has_hair", "has_classic_hair",
                      "has_toon", "has_sheen", "has_aniso")


def check_features(features):
    for k in _UNPORTED_FEATURES:
        if (features or {}).get(k):
            raise NotImplementedError(f"feature {k} is not ported")


def _ggx_smith_lambda(cos_t, alpha2):
    c2 = cos_t * cos_t
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    return 0.5 * (torch.sqrt(1.0 + alpha2 * t2) - 1.0)


def _ggx_d(cos_h, alpha2):
    c2 = cos_h * cos_h
    den = c2 * (alpha2 - 1.0) + 1.0
    return alpha2 / torch.clamp(um.M_PI * den * den, min=1e-12)


def _sample_ggx_vndf(v_local, alpha, u1, u2):
    """Heitz 2018 visible-normal GGX sampling in the tangent frame (z up);
    returns the half vector."""
    vh = um.normalize(torch.stack([alpha * v_local[..., 0],
                                   alpha * v_local[..., 1],
                                   v_local[..., 2]], -1))
    lensq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    big = lensq > 1e-12
    inv = torch.where(big, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12)),
                      0.0)
    t1 = torch.where(big[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], -1),
                     torch.tensor([1.0, 0.0, 0.0], device=vh.device))
    t2 = um.cross(vh, t1)
    r = torch.sqrt(u1)
    phi = um.M_2PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * um.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = um.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return um.normalize(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                                     torch.clamp(nh[..., 2], min=1e-6)], -1))


def _ggx_reflect_eval(wo, wi, alpha):
    """GGX reflection f*cos and pdf in the tangent frame (z = normal)."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    valid = (cos_o > 1e-6) & (cos_i > 1e-6)
    h = um.normalize(wo + wi)
    alpha2 = alpha * alpha
    d = _ggx_d(h[..., 2], alpha2)
    lam_o = _ggx_smith_lambda(cos_o, alpha2)
    lam_i = _ggx_smith_lambda(cos_i, alpha2)
    g = 1.0 / (1.0 + lam_o + lam_i)
    g1_o = 1.0 / (1.0 + lam_o)
    den = torch.clamp(4.0 * cos_o, min=1e-12)
    f_cos = torch.where(valid, d * g / den, 0.0)
    # VNDF pdf: G1(o) D / (4 cos_o)
    pdf = torch.where(valid, g1_o * d / den, 0.0)
    return f_cos, pdf


def _lobe_probs(c, include_sss=True):
    """Lobe pick probabilities (diffuse, glossy, transparent) and the
    total weight, from mean closure weights. include_sss=False when the
    random-walk integrator takes the subsurface lobe itself."""
    wd = torch.mean(c["diffuse"].abs()
                    + (c["subsurface"].abs() if include_sss else 0.0), -1)
    wg = torch.mean(c["glossy"].abs(), -1)
    wt = torch.mean(c["transparent"].abs(), -1)
    tot = wd + wg + wt
    safe = torch.clamp(tot, min=1e-12)
    return wd / safe, wg / safe, wt / safe, tot


def bsdf_eval(c, N, I, omega_in, features=None):
    """The closure stack at direction omega_in -> (f_cos (N,3), pdf (N,));
    delta lobes contribute nothing."""
    check_features(features)
    has_glossy = (features or {}).get("has_glossy", True)
    has_sss_walk = (features or {}).get("has_subsurface", False)
    t, b = um.make_orthonormals(N)
    wo = um.to_local(I, t, b, N)
    wi = um.to_local(omega_in, t, b, N)
    pd, pg, _pt, _tot = _lobe_probs(c, include_sss=not has_sss_walk)
    reflect_side = wi[..., 2] > 0.0
    cos_i = torch.clamp(wi[..., 2], min=0.0)
    sss_part = 0.0 if has_sss_walk else c["subsurface"]
    f_diff = (c["diffuse"] + sss_part) * (cos_i * um.M_1_PI)[..., None]
    pdf_diff = cos_i * um.M_1_PI
    f = f_diff * torch.where(reflect_side, 1.0, 0.0)[..., None]
    pdf = pd * torch.where(reflect_side, pdf_diff, 0.0)
    if has_glossy:
        rough = c["glossy_roughness"]
        alpha_g = torch.clamp(rough * rough, min=1e-7)
        on = (rough >= SHARP_ROUGHNESS) & reflect_side
        fg, pdfg = _ggx_reflect_eval(wo, wi, alpha_g)
        f = f + torch.where(on[..., None], c["glossy"] * fg[..., None], 0.0)
        pdf = pdf + pg * torch.where(on, pdfg, 0.0)
    return f, pdf


def bsdf_sample(c, N, Ng, I, u1, u2, u_lobe, features=None):
    """Sample an outgoing direction from the closure stack. Returns dict
    omega (N,3), f_cos (N,3), pdf (N,), label (N,) int32, valid."""
    check_features(features)
    ft = features or {}
    has_glossy = ft.get("has_glossy", True)
    has_transparent = ft.get("has_transparent", True)
    t, b = um.make_orthonormals(N)
    wo = um.to_local(I, t, b, N)
    pd, pg, pt, tot = _lobe_probs(
        c, include_sss=not ft.get("has_subsurface", False))
    # pick chain over the enabled lobes: each claims [cdf, cdf + p) of
    # u_lobe; the last enabled one absorbs the fp tail
    none = torch.zeros_like(u_lobe, dtype=torch.bool)
    chain = [(pd, True), (pg, has_glossy), (pt, has_transparent)]
    last = max(i for i, (_p, en) in enumerate(chain) if en)
    picks, cdf, taken = [], None, none
    for i, (p, en) in enumerate(chain):
        if not en:
            picks.append(none)
            continue
        cdf = p if cdf is None else cdf + p
        pick = ~taken if i == last else ~taken & (u_lobe < cdf)
        picks.append(pick)
        taken = taken | pick
    pick_d, pick_g, pick_t = picks

    r = torch.sqrt(u1)
    phi = um.M_2PI * u2
    wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                      um.safe_sqrt(1.0 - u1)], -1)
    label = torch.full(pick_d.shape, LABEL_DIFFUSE, dtype=torch.int32,
                       device=u1.device)
    glossy_delta = c["glossy_roughness"] < SHARP_ROUGHNESS
    if has_glossy:
        rough = c["glossy_roughness"]
        h_g = _sample_ggx_vndf(wo, torch.clamp(rough * rough, min=1e-7),
                               u1, u2)
        wi_gloss = 2.0 * um.dot(wo, h_g)[..., None] * h_g - wo
        wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
        wi_gloss = torch.where(glossy_delta[..., None], wi_mirror, wi_gloss)
        wi = torch.where(pick_g[..., None], wi_gloss, wi)
        label = torch.where(
            pick_g, torch.where(glossy_delta, LABEL_GLOSSY | LABEL_SINGULAR,
                                LABEL_GLOSSY), label).to(torch.int32)
    if has_transparent:
        wi = torch.where(pick_t[..., None], -wo, wi)
        label = torch.where(pick_t, LABEL_TRANSPARENT | LABEL_SINGULAR,
                            label).to(torch.int32)
    omega = um.from_local(wi, t, b, N)

    # delta lanes bypass the mixture eval (weight / pick probability)
    sampled_delta = (pick_g & glossy_delta) | pick_t
    f_eval, pdf_eval = bsdf_eval(c, N, I, omega, features)
    f_delta = torch.where(pick_g[..., None], c["glossy"], c["transparent"])
    p_delta = torch.where(pick_g, pg, pt)
    f = torch.where(sampled_delta[..., None], f_delta, f_eval)
    pdf = torch.where(sampled_delta, p_delta, pdf_eval)
    valid = (tot > 1e-12) & (pdf > 1e-12)
    return {"omega": omega, "f_cos": f, "pdf": pdf, "label": label,
            "valid": valid}
