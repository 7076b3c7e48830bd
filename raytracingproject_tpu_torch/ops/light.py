"""Light sampling for NEE and the MIS pdfs (JAX counterpart:
raytracingproject_tpu/ops/light.py light_distribution_sample :33,
sample_light :87, _sample_light_all_tri :403, triangle_light_pdf :464,
lamp_hits :494).

The flat light distribution holds emissive triangles and lamps. An
all-triangle distribution (the static kg["light_kinds"]) takes the
triangle-only sampler; otherwise `sample_light` runs the general path
with per-type selects, as the JAX package does, over the branches the
port has: triangles and distant lamps (a cone of half-angle angle / 2
around -dir). Point, spot, area and background lamps, portals, IES
profiles and the light tree raise NotImplementedError.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.ops import lookup as lk
from raytracingproject_tpu_torch.utils import math as um

LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_BACKGROUND = 2
LIGHT_AREA = 3
LIGHT_SPOT = 4
_KIND_NAMES = {LIGHT_POINT: "point", LIGHT_BACKGROUND: "background",
               LIGHT_AREA: "area", LIGHT_SPOT: "spot"}


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
    kinds = set(static_kinds or ())
    if kinds == {"tri"}:
        return _sample_light_all_tri(dscene, P, u_sel, u1, u2, rows)
    unported = sorted(_KIND_NAMES.get(k, str(k))
                      for k in kinds - {"tri", LIGHT_DISTANT})
    if not kinds or unported:
        raise NotImplementedError(
            f"lamp types {unported or 'unknown'} are not ported (triangle "
            "and distant lights are)")
    return _sample_light_tri_distant(dscene, P, u_sel, u1, u2, rows)


def _sample_light_tri_distant(dscene, P, u_sel, u1, u2, rows=None):
    """The JAX package's general sample_light with the point/spot/area
    /background branches absent: every output is what its per-type
    selects give for triangle and distant entries."""
    n = P.shape[0]
    if rows is None:
        eidx, erow = light_distribution_sample(dscene, u_sel)
        rows = {"erow": erow,
                "prow": lk.lookup_rows(dscene["le_prim_rows"], eidx),
                "orow": lk.lookup_rows(dscene["le_obj_rows"], eidx),
                "lrow": lk.lookup_rows(dscene["le_lamp_rows"], eidx)}
    erow, prow, orow, lrow = (rows["erow"], rows["prow"], rows["orow"],
                              rows["lrow"])
    is_tri = erow[:, 0].to(torch.int32) == 1
    pmf = erow[:, 2]
    # triangles: a uniform point (sqrt warp) on the picked triangle
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    tri_emission = prow[:, lk.PT_EMISSION:lk.PT_EMISSION + 3]
    otfm = lk.mat34(orow[:, lk.OT_TFM:lk.OT_TFM + 12])
    v0 = um.mat34_point(otfm, tv[:, 0])
    v1 = um.mat34_point(otfm, tv[:, 1])
    v2 = um.mat34_point(otfm, tv[:, 2])
    su = torch.sqrt(torch.clamp(u1, min=0.0))
    tb_u = 1.0 - su
    tb_v = u2 * su
    P_tri = v0 + (v1 - v0) * tb_u[:, None] + (v2 - v0) * tb_v[:, None]
    Ng_tri = um.triangle_normal(v0, v1, v2)
    area_tri = um.triangle_area(v0, v1, v2)
    # lamps: the table row of the picked entry
    ltype = lrow[:, lk.LT_TYPE].to(torch.int32)
    lco = lrow[:, lk.LT_CO:lk.LT_CO + 3]
    ldir = lrow[:, lk.LT_DIR:lk.LT_DIR + 3]
    lsize = lrow[:, lk.LT_SIZE]
    lstrength = lrow[:, lk.LT_STRENGTH:lk.LT_STRENGTH + 3]
    langle = lrow[:, lk.LT_ANGLE]
    is_distant = ~is_tri & (ltype == LIGHT_DISTANT)
    # a lamp's position sample (point lamps' sphere; P_l of a distant
    # entry, which no caller reads, keeps the JAX package's value)
    P_point = lco + um.sample_uniform_sphere(u1, u2) * lsize[:, None]
    # distant: a direction in the cone of half-angle angle / 2 around -dir
    cos_max = torch.cos(langle * 0.5)
    zc = 1.0 - u1 * (1.0 - cos_max)
    rc = um.safe_sqrt(1.0 - zc * zc)
    phic = um.M_2PI * u2
    t_d, b_d = um.make_orthonormals(-ldir)
    D_distant = um.normalize(
        (rc * torch.cos(phic))[:, None] * t_d
        + (rc * torch.sin(phic))[:, None] * b_d + zc[:, None] * (-ldir))

    P_l = torch.where(is_tri[:, None], P_tri, P_point)
    to_l = P_l - P
    dist = torch.clamp(um.length(to_l), min=1e-8)
    D = torch.where(is_distant[:, None], D_distant, to_l / dist[:, None])
    dist = torch.where(is_distant, um.RAY_TMAX, dist)
    Ng_l = torch.where(is_tri[:, None], Ng_tri, -D)
    cos_l = um.dot(Ng_l, -D)
    d2 = dist * dist
    pdf_tri = um.safe_divide(d2, cos_l.abs() * area_tri, 0.0)
    pdf_distant = 1.0 / (um.M_2PI * torch.clamp(1.0 - cos_max, min=1e-9))
    delta = is_distant & (cos_max >= 1.0 - 1e-9)
    pdf = torch.where(is_tri, pdf_tri, torch.where(delta, 1.0, pdf_distant))
    pdf = pdf * pmf
    ev = torch.where(is_tri[:, None], tri_emission, lstrength)
    valid = (pdf > 1e-12) & (torch.where(is_tri, cos_l.abs(), 1.0) > 1e-6) \
        & (erow[:, 1] >= 0.0)
    false = torch.zeros(n, dtype=torch.bool, device=P.device)
    return {"valid": valid, "delta": delta, "is_bg": false,
            "D": D, "dist": dist, "pdf": pdf, "eval": ev,
            "Ng_l": Ng_l, "P_l": P_l, "pmf": pmf, "rows": rows,
            "is_tri": is_tri}


def _sample_light_all_tri(dscene, P, u_sel, u1, u2, rows=None):
    """Uniform-area point on a power-picked emissive triangle. Returns
    dict valid, delta, is_bg, D (unit direction to the light), dist, pdf
    (solid angle x pick pmf), eval (emitted radiance), Ng_l, P_l, pmf,
    the picked entry rows and is_tri (the sample lies on a triangle)."""
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
            "Ng_l": Ng_l, "P_l": P_l, "pmf": pmf, "rows": rows,
            "is_tri": ~false}


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
    """Analytic area-lamp hits for BSDF MIS: a no-op without area lamps;
    area lamps are not ported."""
    for ltype in lamp_types:
        if int(ltype) == LIGHT_AREA:
            raise NotImplementedError("area lamps are not ported")
