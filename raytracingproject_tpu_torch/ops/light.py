"""Light sampling for NEE and the MIS pdfs (JAX counterpart:
raytracingproject_tpu/ops/light.py light_distribution_sample :33,
_sample_light_all_tri :403, triangle_light_pdf :464, lamp_hits :494).

This slice's scenes light with emissive triangles only (the static
"all-triangle" distribution, kg["light_kinds"]); lamps, the background
light and the light tree raise NotImplementedError.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.ops import lookup as lk
from raytracingproject_tpu_torch.utils import math as um

LIGHT_AREA = 3


def light_distribution_sample(dscene, u):
    """Invert the emission CDF. Returns (entry_index, entry_row (N, 4):
    [type, id, pmf, _])."""
    idx = lk.searchsorted_cdf(dscene["light_dist_cdf"], u)
    return idx, lk.lookup_rows(dscene["light_entries"], idx)


def sample_light(dscene, P, u_sel, u1, u2, static_kinds=None, rows=None):
    """One NEE light sample per shading point P (N, 3). `rows`: the
    entry rows a previous sample_light call with the same randoms picked
    (the equiangular volume NEE re-evaluates that light point from
    another observer without fetching them again)."""
    if not static_kinds or set(static_kinds) != {"tri"}:
        raise NotImplementedError(
            "only all-triangle light distributions are ported")
    return _sample_light_all_tri(dscene, P, u_sel, u1, u2, rows)


def _sample_light_all_tri(dscene, P, u_sel, u1, u2, rows=None):
    """Uniform-area point on a power-picked emissive triangle. Returns
    dict valid, delta, is_bg, D (unit direction to the light), dist, pdf
    (solid angle x pick pmf), eval (emitted radiance), Ng_l, P_l, pmf and
    the picked entry rows."""
    n = P.shape[0]
    if rows is None:
        eidx, erow = light_distribution_sample(dscene, u_sel)
        rows = {"erow": erow,
                "prow": lk.lookup_rows(dscene["le_prim_rows"], eidx),
                "orow": lk.lookup_rows(dscene["le_obj_rows"], eidx)}
    erow, prow, orow = rows["erow"], rows["prow"], rows["orow"]
    pmf = erow[:, 2]
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    tri_emission = prow[:, lk.PT_EMISSION:lk.PT_EMISSION + 3]
    otfm = lk.mat34(orow[:, lk.OT_TFM:lk.OT_TFM + 12])
    v0 = um.mat34_point(otfm, tv[:, 0])
    v1 = um.mat34_point(otfm, tv[:, 1])
    v2 = um.mat34_point(otfm, tv[:, 2])
    su = torch.sqrt(torch.clamp(u1, min=0.0))
    tb_u = 1.0 - su
    tb_v = u2 * su
    P_l = v0 + (v1 - v0) * tb_u[:, None] + (v2 - v0) * tb_v[:, None]
    Ng_l = um.triangle_normal(v0, v1, v2)
    area_tri = um.triangle_area(v0, v1, v2)
    to_l = P_l - P
    dist = torch.clamp(um.length(to_l), min=1e-8)
    D = to_l / dist[:, None]
    cos_l = um.dot(Ng_l, -D)
    d2 = dist * dist
    pdf = um.safe_divide(d2, cos_l.abs() * area_tri, 0.0) * pmf
    valid = (pdf > 1e-12) & (cos_l.abs() > 1e-6) & (erow[:, 1] >= 0.0)
    false = torch.zeros(n, dtype=torch.bool, device=P.device)
    return {"valid": valid, "delta": false, "is_bg": false,
            "D": D, "dist": dist, "pdf": pdf, "eval": tri_emission,
            "Ng_l": Ng_l, "P_l": P_l, "pmf": pmf, "rows": rows}


def triangle_light_pdf(dscene, prim_row, t_hit, cos_hit):
    """Solid-angle pdf with which NEE would have sampled the emissive
    triangle a BSDF ray hit; prim_row = (prim_table rows, object->world
    transforms) already fetched by shader_setup."""
    prow, otfm = prim_row
    pmf = prow[:, lk.PT_LIGHT_PMF]
    n = prow.shape[0]
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    v0 = um.mat34_point(otfm, tv[:, 0])
    v1 = um.mat34_point(otfm, tv[:, 1])
    v2 = um.mat34_point(otfm, tv[:, 2])
    area = um.triangle_area(v0, v1, v2)
    return um.safe_divide(t_hit * t_hit, cos_hit.abs() * area, 0.0) * pmf


def lamp_hits(dscene, lamp_types, o, d, tmax, accum_fn):
    """Analytic area-lamp hits for BSDF MIS: a no-op without area lamps
    (this slice's case); area lamps are not ported."""
    for ltype in lamp_types:
        if int(ltype) == LIGHT_AREA:
            raise NotImplementedError("area lamps are not ported")
