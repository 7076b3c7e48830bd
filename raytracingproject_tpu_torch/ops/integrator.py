"""Wavefront path integrator (JAX counterpart:
raytracingproject_tpu/ops/integrator.py make_path_kernel :432,
path_trace_sample :1827, render_samples :1854, render_samples_regen
:1879, render_samples_adaptive_chunk :2087, _scene_intersect_tris :171,
_use_pallas_occlusion :151, _use_fused_nee :273, _shadow_blocked :328,
_offset_eps :38, _clamp_contrib :420).

`make_path_kernel` returns (start_paths, step): start_paths creates a
fresh per-lane path state from camera rays; step advances every lane one
bounce -- intersect, the volume segment (homogeneous media and the
random walk of subsurface scattering, :666-783), the background shader on
a miss (:799-826; textures included), surface emission with MIS, NEE
with MIS over emissive triangles and distant lamps and a shadow test
(a distant lamp's shadow ray runs to RAY_TMAX, :1194-1201; for volume
scenes the dual sweep with medium attenuation and equiangular NEE,
:1141-1540),
BSDF or phase-function bounce with SSS entry and the volume stack
(:1540-1760), Russian roulette.

Fused-NEE mode (kg["fused_nee"], opt-in; `_use_fused_nee` holds the
scenes it serves: plain surfaces on single-level cluster tables with at
least one light): `make_path_kernel` returns (start_paths, step, seed,
finish). step reads the hit its ray was given by the previous union walk
and defers its shadow test; finish answers that shadow test and the next
ray's closest hit in one call of K7 (ops/dual_walk.py) and then adds the
NEE contribution, in the same place of the sample's accumulation order
as the unfused step; seed traces a fresh state's camera rays. A scene
the mode does not serve renders unfused.

Render loops: `path_trace_sample` and `render_samples` trace a fixed grid of
max_bounce + 1 steps per sample; `render_samples_regen` keeps the
wavefront full by restarting dead lanes on their pixel's next sample, and
`render_samples_adaptive_chunk` does so from a per-lane first sample and
also returns the even samples' sum (the JAX lax.while_loops are Python
loops here). In fused mode a dying lane is merged and regenerated after
the shading half, so its last shadow ray and its next sample's camera
ray share one K7 call. Same sample sequence and the same per-sample
accumulation order as the JAX package, so the fixed grid and the
regenerating loops agree to the bit.

Not ported, and raising: heterogeneous media, volume NEE without the
dual sweep, background light sampling (bg_pmf > 0), AO/bevel nodes, bump,
aux and light passes, shadow catchers, holdouts, transparent shadows,
debug_ablate and the branched integrator.

Intersection dispatch follows the JAX package's flags and precedence
(ops/integrator.py :129-270 there): kg["use_brute"] (scenes of at most
1,024 static prims) selects the dense sweep K1 (ops/dense_sweep.py) for
the closest hit, the NEE shadow test (its any-hit mode) and the volume
dual sweep (its dual form). Two-level tables (sc_bounds, big and
instanced scenes) under kg["pallas_clusters2"] (default "auto" = on):
kg["pallas_onehot2"] (opt-in) selects K6 (ops/onehot2_walk.py) where the
tables are within its capacity (sc_gmax <= 128 and the JAX package's
VMEM estimate for its group tables: onehot2_walk.fits), else the
two-level walk K5
(ops/cluster2_walk.py). Single-level tables: kg["pallas_onehot"]
(default "auto" = on) the per-lane walk K2 (ops/cluster_walk.py) where
the table has at most 512 clusters; else kg["pallas_clusters"] (default
"auto" = on) the tile-shared walk K4 (ops/tile_walk.py, up to 640;
`_closest_walk_name`). With the chosen kernel's flag False the plain walk
ops/cluster_intersect.py runs, on CPU tensors only. The NEE shadow test
and the volume dual sweep go through K3 (ops/occlusion_walk.py) when
kg["pallas_occlusion"] allows (default: every single-level cluster scene
that is not use_brute; never on two-level tables); otherwise the shadow
test is the closest-hit walk's any-hit mode (K5's or K6's on
big_instanced). On CUDA tensors the sweeps and walks launch their
kernels; on CPU tensors they run their plain torch versions.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.ops import bsdf as bsdf_ops
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.ops import closures as cl
from raytracingproject_tpu_torch.ops import cluster2_walk
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk
from raytracingproject_tpu_torch.ops import dense_sweep
from raytracingproject_tpu_torch.ops import dual_walk
from raytracingproject_tpu_torch.ops import film as film_ops
from raytracingproject_tpu_torch.ops import light as light_ops
from raytracingproject_tpu_torch.ops import occlusion_walk
from raytracingproject_tpu_torch.ops import onehot2_walk
from raytracingproject_tpu_torch.ops import shade as shade_ops
from raytracingproject_tpu_torch.ops import tile_walk
from raytracingproject_tpu_torch.ops import volume as vol_ops
from raytracingproject_tpu_torch.utils import math as um
from raytracingproject_tpu_torch.utils import rng as rngu

RAY_EPS = 1e-4
# float32 ulps of the coordinates by which a walk's crossing of a light
# triangle's plane may round, in height (_light_plane_tmax)
GRAZE_ULPS = 8.0
HIT_KEYS = ("t", "prim", "u", "v", "object")


def _offset_eps(P, t):
    """Scale-aware ray-origin offset: an absolute 1e-4 is ~2 f32 ulps at
    coordinates ~500, so the epsilon grows with |P| and the ray length."""
    scale = torch.clamp(torch.maximum(P.abs().amax(-1),
                                      torch.clamp(t, max=1e6)), min=1.0)
    return RAY_EPS * scale


def _clamp_contrib(contrib, clamp):
    """Per-sample firefly clamp; `clamp` is a python float (<= 0
    disables) or a per-lane tensor."""
    if isinstance(clamp, float) and clamp <= 0.0:
        return contrib
    m = contrib.amax(-1)
    clamp = torch.as_tensor(clamp, device=contrib.device)
    scale = torch.where((clamp > 0.0) & (m > clamp),
                        clamp / torch.clamp(m, min=1e-12), 1.0)
    return contrib * scale[..., None]


def _check_cluster_scene(kg):
    ds = kg["dscene"]
    if "cluster_bounds" not in ds or int(kg.get("cluster_tris", 0)) <= 0:
        raise NotImplementedError("scene has no cluster tables")


def _deform(kg, time):
    """The dense sweeps' deform arguments (tri_verts_t1, time): the
    whole step path of a deforming scene when the rays carry a time."""
    if not kg.get("has_deform_motion") or time is None:
        return {}
    ds = kg["dscene"]
    return {"tri_verts_t1": ds.get("tri_verts_world_steps",
                                   ds.get("tri_verts_world_t1")),
            "time": time}


def _motion(kg, time):
    """The cluster walks' motion arguments: the rays' times where the
    rows carry shutter deltas."""
    if not kg.get("cluster_motion"):
        return {}
    return {"time": time, "has_motion": True}


def _flag(kg, name):
    """A dispatch flag: "auto" (or absent) is on, the card's choice."""
    mode = kg.get(name, "auto")
    return True if mode == "auto" else bool(mode)


def _closest_walk_name(kg):
    """The walk of single-level cluster tables, as the JAX package picks
    it: K2 ("cluster_walk") under pallas_onehot where the table fits its
    packed keys (C <= 512: the reference packs its one-hot tables only
    then), else K4 ("tile_walk", up to 640 clusters) under
    pallas_clusters, else None (the plain walk)."""
    ds = kg["dscene"]
    c = int(ds["cluster_bounds"].shape[0])
    if _flag(kg, "pallas_onehot") \
            and cluster_walk.fits(c, int(ds["cluster_table"].shape[1])):
        return "cluster_walk"
    if _flag(kg, "pallas_clusters"):
        return "tile_walk"
    return None


def _scene_intersect_tris(kg, o, d, tmin, tmax, visibility, shadow=False,
                          time=None):
    """Closest hit (any hit with shadow=True) through K1 on use_brute
    scenes, K5 or K6 on two-level tables, K2 or K4 on single-level ones,
    or, on the CPU with the kernel's flag off, the plain walk. time (N,)
    is the rays' shutter time, read where the scene deforms."""
    ds = kg["dscene"]
    if kg["use_brute"]:
        return dense_sweep.intersect_brute_sweep(
            ds["tri_verts_world"], ds["prim_object_packed"], o, d, tmin, tmax,
            visibility=visibility,
            object_visibility=ds["object_visibility"], **_deform(kg, time))
    _check_cluster_scene(kg)
    inst = bool(kg.get("has_instances", False))
    mot = _motion(kg, time)
    args = (ds["cluster_bounds"], ds["cluster_table"],
            int(kg["cluster_tris"]), o, d, tmin, tmax, visibility)
    if "sc_bounds" in ds:
        if _flag(kg, "pallas_clusters2"):
            # K6 is opt-in only, and only where the tables are within its
            # capacity (where the JAX package packs its oh2_* tables); K5
            # otherwise
            walk2 = cluster2_walk.intersect_clusters2_walk
            if bool(kg.get("pallas_onehot2", False)) \
                    and onehot2_walk.fits(kg["sc_gmax"],
                                          ds["sc_bounds"].shape[0],
                                          ds["cluster_table"].shape[1]):
                walk2 = onehot2_walk.intersect_clusters2_onehot
            return walk2(
                ds["sc_bounds"], *args[:3], int(kg["sc_gmax"]), *args[3:],
                shadow_any_hit=shadow, has_instances=inst, **mot)
        kernel_flags = "pallas_clusters2 (K5)"
    elif (walk := _closest_walk_name(kg)) is not None:
        fn = (cluster_walk.intersect_clusters_walk if walk == "cluster_walk"
              else tile_walk.intersect_clusters_tile)
        return fn(*args, shadow_any_hit=shadow, has_instances=inst, **mot)
    else:
        kernel_flags = "pallas_onehot (K2) or pallas_clusters (K4)"
    if o.device.type != "cpu":
        raise NotImplementedError(
            "the plain cluster walk is not a render path on the card: set "
            + kernel_flags)
    return ci.intersect_clusters(*args, shadow_any_hit=shadow,
                                 has_instances=inst, **mot)


def _use_occlusion_walk(kg):
    """K3 for the NEE shadow test and the volume dual sweep: "auto"
    follows the main dispatch (every single-level cluster scene that is
    not use_brute); True forces it wherever single-level cluster tables
    exist. Never on two-level tables: K3 walks every cluster of the
    table, which the two-level scenes are too big for."""
    ds = kg["dscene"]
    if "cluster_boundary" not in ds or "cluster_bounds" not in ds \
            or int(kg.get("cluster_tris", 0)) <= 0 or "sc_bounds" in ds:
        return False
    mode = kg.get("pallas_occlusion", "auto")
    return (not kg["use_brute"]) if mode == "auto" else bool(mode)


def _occlusion(kg, o, d, tmin, tmax_closest, tmax_any, time=None):
    """K3: (t_boundary, t_other, blocked) under camera visibility for
    the closest window and shadow visibility for the any-hit window."""
    _check_cluster_scene(kg)
    ds = kg["dscene"]
    return occlusion_walk.occlusion_clusters_walk(
        ds["cluster_bounds"], ds["cluster_table"], ds["cluster_boundary"],
        int(kg["cluster_tris"]), o, d, tmin, tmax_closest=tmax_closest,
        tmax_any=tmax_any, vis_closest=ob.PATH_RAY_CAMERA,
        vis_any=ob.PATH_RAY_SHADOW,
        has_instances=bool(kg.get("has_instances", False)),
        **_motion(kg, time))


def _shadow_blocked(kg, o, d, tmin, tmax, time=None):
    vis = torch.full(o.shape[:1], ob.PATH_RAY_SHADOW, dtype=torch.int32,
                     device=o.device)
    if kg["use_brute"]:
        ds = kg["dscene"]
        return dense_sweep.shadow_blocked_sweep(
            ds["tri_verts_world"], ds["prim_object_packed"], o, d, tmin, tmax,
            visibility=vis, object_visibility=ds["object_visibility"],
            **_deform(kg, time))
    if _use_occlusion_walk(kg):
        # pure any-hit: the closest window is empty ([tmin, tmin])
        return _occlusion(kg, o, d, tmin, tmin, tmax, time)[2]
    hit = _scene_intersect_tris(kg, o, d, tmin, tmax, vis, shadow=True,
                                time=time)
    return hit["prim"] >= 0


def _light_plane_tmax(ls, o, d, dist, tmax):
    """The NEE shadow segment's end, pulled back where the ray grazes the
    plane of the sampled light triangle. The segment toward a point of
    that triangle ends 0.1% short of the point, so that the triangle does
    not block its own sample; but the walk's crossing of that plane rounds
    by a few float32 ulps of the coordinates in height, which is that
    height over |Ng_l . d| along the ray: a ray nearly in the plane (an
    origin offset to within a few thousandths of it) can meet the triangle
    inside the segment and lose its own light (the JAX package's render
    blocks or passes such a sample depending on the wavefront's shape).
    So the segment ends at least GRAZE_ULPS ulps of the larger coordinate,
    over |Ng_l . d|, short of the light point; a ray that is not grazing
    keeps its segment."""
    cos_l = um.dot(ls["Ng_l"], d).abs()
    h = (GRAZE_ULPS * 2.0 ** -23) * torch.maximum(
        o.abs().amax(-1), ls["P_l"].abs().amax(-1))
    end = torch.clamp(dist - h / torch.clamp(cos_l, min=1e-30) - RAY_EPS,
                      min=1e-5)
    return torch.where(ls["is_tri"], torch.minimum(tmax, end), tmax)


def _use_fused_nee(kg):
    """Whether kg["fused_nee"] (opt-in) applies: one union walk per bounce
    answers this bounce's NEE shadow test and the next ray's closest hit
    (K7). Only the plain-surface configuration the union walk models: no
    volume or subsurface (they have their own dual sweep), no transparent
    shadows, single-level cluster tables walked per lane (the
    pallas_onehot flag), no motion rows, at least one light."""
    if not kg.get("fused_nee", False):
        return False
    feats = kg.get("features") or {}
    if feats.get("has_volume") or feats.get("has_subsurface"):
        return False
    if any(kg.get("shader_shadow_transparent", ())):
        return False
    ds = kg["dscene"]
    if "cluster_bounds" not in ds or int(kg.get("cluster_tris", 0)) <= 0 \
            or "sc_bounds" in ds or kg["use_brute"]:
        return False
    if kg.get("cluster_motion") or kg.get("has_motion"):
        return False
    if int(ds["light_dist_type"].shape[0]) == 0:
        return False
    return _flag(kg, "pallas_onehot") \
        and cluster_walk.fits(ds["cluster_bounds"].shape[0],
                              int(ds["cluster_table"].shape[1]))


def _dual_walk(kg, o_c, d_c, tmin_c, tmax_c, vis_c, o_a, d_a, tmax_a, vis_a):
    """K7: (closest hit of ray c, blocked of ray a); the any-hit window
    starts at 1e-5 and an empty window (tmax < tmin) disables a ray."""
    ds = kg["dscene"]
    tmin_a = torch.full_like(tmax_a, 1e-5)
    return dual_walk.intersect_clusters_dual_walk(
        ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
        o_c, d_c, tmin_c, tmax_c, vis_c, o_a, d_a, tmin_a, tmax_a, vis_a,
        has_instances=bool(kg.get("has_instances", False)))


_UNPORTED_KG = ("has_shadow_catcher", "light_passes", "aux_passes",
                "film_transparent", "sorted_shading", "ray_override",
                "debug_ablate")


def make_path_kernel(kg, px, py, pixel_index):
    """Build (start_paths, step), or in fused-NEE mode (start_paths, step,
    seed, finish), for a wavefront of pixels (px, py, pixel_index: (N,)
    int64 tensors on the render device)."""
    for k in _UNPORTED_KG:
        if kg.get(k):
            raise NotImplementedError(f"kg['{k}'] is not ported")
    features = kg.get("features") or {}
    bsdf_ops.check_features(features)
    if kg.get("light_tree") is not None:
        raise NotImplementedError("the light tree is not ported")
    kint = kg["kint"]
    if int(kint["method"]) != 0:
        raise NotImplementedError("the branched integrator is not ported")
    pattern = int(kint["sampling_pattern"])
    seed = int(kint["seed"])
    max_bounce = int(kint["max_bounce"])
    min_bounce = int(kint["min_bounce"])
    clamp_direct = float(kint["sample_clamp_direct"])
    clamp_indirect = float(kint["sample_clamp_indirect"])
    dev = px.device
    n = px.shape[0]
    rng_hash = rngu.pixel_rng_hash(pixel_index, seed)
    ds = kg["dscene"]
    has_lights = int(ds["light_dist_type"].shape[0]) > 0
    fused = _use_fused_nee(kg)
    if float(ds["bg_pmf"]) > 0.0:
        raise NotImplementedError("background light sampling is not ported")
    has_volume = bool(features.get("has_volume", False))
    has_sss = bool(features.get("has_subsurface", False))
    has_medium = has_volume or has_sss
    has_equiangular = has_volume \
        and bool(features.get("has_equiangular", False))
    if has_volume and features.get("has_heterogeneous"):
        raise NotImplementedError("heterogeneous media are not ported")
    # volume NEE: one dual sweep answers the shadow any-hit and the
    # medium-boundary closest hit of the same segment
    use_dual_shadow = has_volume \
        and not any(kg.get("shader_shadow_transparent", ())) \
        and (bool(kg["use_brute"]) or _use_occlusion_walk(kg))
    if has_volume and has_lights and not use_dual_shadow:
        raise NotImplementedError(
            "volume NEE without the dual occlusion sweep is not ported")
    if has_volume:
        nsh = len(kg["shaders"])

        def per_shader(key, dtype):
            return torch.tensor(list(kg[key]), dtype=dtype, device=dev)

        shader_vol = per_shader("shader_has_volume", torch.bool)
        vol_only = per_shader("shader_volume_only", torch.float32)
        vol_sampling = per_shader("shader_vol_sampling", torch.int32)

    def rng2_batch(dim_pairs, samples):
        """All of a stage's dimension pairs in one sampler call: dims are
        (K,) shared or (K, N) per lane; returns two (K, N) tensors."""
        dims = torch.as_tensor(dim_pairs, device=dev)
        if dims.ndim == 1:
            dims = dims[:, None]
        return rngu.path_rng_2d(rng_hash[None, :], samples[None, :], dims,
                                pattern)

    def i32(v):
        return torch.full((n,), v, dtype=torch.int32, device=dev)

    def start_paths(samples):
        (fu, lens_u, time_u), (fv, lens_v, _) = rng2_batch(
            [rngu.PRNG_FILTER, rngu.PRNG_LENS, rngu.PRNG_TIME], samples)
        ft = kg["filter_table"]
        raster_x = px.to(torch.float32) + 0.5 \
            + film_ops.filter_table_lookup(ft, fu)
        raster_y = py.to(torch.float32) + 0.5 \
            + film_ops.filter_table_lookup(ft, fv)
        ray = cam_ops.camera_sample_ray(kg["cam"], raster_x, raster_y,
                                        lens_u, lens_v, time_u)
        zero = torch.zeros(n, device=dev)
        st = {
            "o": ray["o"], "d": ray["d"],
            "tmin": ray["tmin"], "tmax": ray["tmax"], "time": ray["time"],
            "throughput": torch.ones((n, 3), device=dev),
            "L": torch.zeros((n, 3), device=dev),
            "alpha": torch.ones(n, device=dev),
            "alive": torch.ones(n, dtype=torch.bool, device=dev),
            "pdf_prev": zero,
            "singular_prev": torch.ones(n, dtype=torch.bool, device=dev),
            "path_flag": i32(ob.PATH_RAY_CAMERA),
            "diffuse_depth": i32(0), "glossy_depth": i32(0),
            "transmission_depth": i32(0), "transparent_depth": i32(0),
            "bounce": i32(0),
            "sample": samples,
        }
        if has_volume:
            # volume stack: vol_shader is the current medium (top),
            # vol_rest the enclosing media below it
            vk = max(2, int(kg.get("volume_stack_depth", 4)))
            st["vol_shader"] = i32(-1)
            st["vol_rest"] = torch.full((n, vk - 1), -1, dtype=torch.int32,
                                        device=dev)
        if has_sss:
            st["in_sss"] = torch.zeros(n, dtype=torch.bool, device=dev)
            st["sss_sigma_t"] = torch.zeros((n, 3), device=dev)
            st["sss_albedo"] = torch.ones((n, 3), device=dev)
        return st

    def vis_of_flag(flag):
        return torch.where(
            (flag & ob.PATH_RAY_CAMERA) > 0, ob.PATH_RAY_CAMERA,
            torch.where((flag & ob.PATH_RAY_DIFFUSE) > 0, ob.PATH_RAY_DIFFUSE,
                        torch.where((flag & ob.PATH_RAY_TRANSMIT) > 0,
                                    ob.PATH_RAY_TRANSMIT,
                                    ob.PATH_RAY_GLOSSY))).to(torch.int32)

    def dual_sweep(o_s, d_s, on_any, on_closest, tmax_s, time):
        """((t_boundary, t_other), blocked) of one segment at the rays'
        shutter times; disabled lanes get the empty window [1e-5,
        1e-5]."""
        tmin = torch.full((n,), 1e-5, device=dev)
        o_s, d_s = o_s.contiguous(), d_s.contiguous()
        tmax_c = torch.where(on_closest,
                             torch.clamp(tmax_s, max=um.RAY_TMAX), 1e-5)
        tmax_a = torch.where(on_any, tmax_s, 1e-5)
        if _use_occlusion_walk(kg):
            t_b, t_o, blk = _occlusion(kg, o_s, d_s, tmin, tmax_c, tmax_a,
                                       time)
        else:
            t_b, t_o, blk = dense_sweep.occlusion_sweep(
                ds["tri_verts_world"], ds["prim_object_packed"],
                ds["prim_is_boundary"], o_s, d_s, tmin, tmax_c, tmax_a,
                i32(ob.PATH_RAY_CAMERA), i32(ob.PATH_RAY_SHADOW),
                ds["object_visibility"], **_deform(kg, time))
        return (t_b, t_o), blk

    def vol_nee_attenuation(sigma_t, boundary_hit, dist_l):
        """Medium transmittance from an in-volume point to the medium
        boundary along an NEE segment, and whether a non-boundary surface
        blocks the segment first (the dual sweep's two minima)."""
        t_bb, t_oo = boundary_hit
        t_first = torch.minimum(t_bb, t_oo)
        found = t_first < um.RAY_TMAX * 0.5
        t_seg = torch.where(found, t_first, torch.clamp(dist_l, max=1e6))
        trans = torch.exp(-sigma_t * t_seg[:, None])
        return trans, found & ~(t_bb <= t_oo)

    def medium_segment(st, hit, throughput, L, phase_v, lobe_u):
        """Homogeneous medium along the ray segment up to the hit: the
        distance sample, emission, and the segment's throughput weight."""
        alive = st["alive"]
        if has_volume:
            in_vol = alive & (st["vol_shader"] >= 0)
            d = st["d"]
            vctx = shade_ops.ShaderData(
                P=st["o"], N=-d, Ng=-d, Ns=-d, I=-d, time=st["time"],
                ray_length=hit["t"], ray_depth=st["bounce"],
                path_flag=st["path_flag"], prim=hit["prim"],
                shader=st["vol_shader"], object_index=hit["object"],
                backfacing=torch.zeros(n, dtype=torch.bool, device=dev),
                batch_shape=(n,), device=dev)
            vc = vol_ops.eval_volume_closures(
                kg["shaders"], kg["shader_has_volume"], st["vol_shader"], n,
                vctx)
        else:
            in_vol = torch.zeros(n, dtype=torch.bool, device=dev)
            vc = cl.empty_volume_closures((n,), dev)
        if has_sss:
            # the SSS walk: a pure-scattering medium set at entry
            in_sss = alive & st["in_sss"]
            vc = dict(vc)
            vc["sigma_t"] = torch.where(in_sss[:, None], st["sss_sigma_t"],
                                        vc["sigma_t"])
            vc["sigma_s"] = torch.where(
                in_sss[:, None], st["sss_sigma_t"] * st["sss_albedo"],
                vc["sigma_s"])
            vc["anisotropy"] = torch.where(in_sss, 0.0, vc["anisotropy"])
            in_vol = in_vol | in_sss
        # rng: the PHASE pair's v for the distance, the TERMINATE pair's
        # v for the channel (volume lanes make no surface lobe pick)
        dres = vol_ops.sample_distance_homogeneous(
            vc["sigma_t"], throughput, hit["t"], phase_v, lobe_u)
        # no sigma_s gate: a scatter in a purely absorbing medium carries
        # weight 0 and ends the lane, which is the absorption estimator
        scattered = in_vol & dres["scatter"]
        seg_t = torch.where(scattered, dres["t_scatter"], hit["t"])
        L = torch.where(in_vol[:, None],
                        L + throughput * vol_ops.emission_integral(
                            vc["v_emission"], vc["sigma_t"], seg_t), L)
        w_seg = torch.where(scattered[:, None],
                            dres["weight_scatter"] * vc["sigma_s"],
                            dres["weight_pass"])
        throughput = torch.where(in_vol[:, None], throughput * w_seg,
                                 throughput)
        P_scatter = st["o"] + st["d"] * dres["t_scatter"][:, None]
        return vc, dres, scattered, P_scatter, throughput, L

    def equiangular_nee(st, hit, ls, vc, vol_g, dres, sel_u, lu, lv,
                        clamp_val, L):
        """Equiangular volume NEE, decoupled from the path continuation:
        a scatter point drawn toward the sampled light point, MIS-weighted
        against distance sampling in multiple-importance mode. Returns
        (L, weight for the distance-point NEE contribution, mask of lanes
        whose distance-point NEE pure equiangular replaces)."""
        vs = torch.clamp(st["vol_shader"], 0, nsh - 1).long()
        mode_lane = vol_sampling[vs]
        # every traversed volume segment, scattered or not
        eq_vol = st["alive"] & (st["vol_shader"] >= 0)
        if has_sss:
            eq_vol = eq_vol & ~st["in_sss"]
        eq_lane = eq_vol & (mode_lane >= 1)
        mis_lane = eq_vol & (mode_lane == 2)
        t_seg_max = hit["t"]
        thr0 = st["throughput"]
        # position lights only (distant ones have no pivot point)
        pos_light = ls["valid"] & ~ls["is_bg"] \
            & (ls["dist"] < um.RAY_TMAX * 0.5)
        eq_seed = rngu.hash_pcg3d(pixel_index, st["sample"],
                                  st["bounce"].long() ^ 0x51ED270B)
        u_eq = rngu.uint_to_float_01(eq_seed)
        t_eq, pdf_eq, eq_geom = vol_ops.equiangular_sample(
            st["o"], st["d"], t_seg_max, ls["P_l"], u_eq)
        eq_ok = eq_geom & eq_lane & pos_light & (pdf_eq > 1e-12)
        P_eq = st["o"] + st["d"] * t_eq[:, None]
        # the same light point seen from the equiangular point
        ls_eq = light_ops.sample_light(ds, P_eq, sel_u, lu, lv,
                                       static_kinds=kg.get("light_kinds"),
                                       rows=ls["rows"])
        T_eq = torch.exp(-vc["sigma_t"] * t_eq[:, None])
        ph_eq = vol_ops.hg_phase_eval(um.dot(st["d"], ls_eq["D"]), vol_g)
        w_l_eq = torch.where(ls_eq["delta"], 1.0,
                             um.power_heuristic(ls_eq["pdf"], ph_eq))
        pdf_d_at_eq = vol_ops.distance_pdf(vc["sigma_t"], thr0, t_eq)
        w_t_eq = torch.where(mis_lane,
                             um.power_heuristic(pdf_eq, pdf_d_at_eq), 1.0)
        contrib_eq = thr0 * T_eq * vc["sigma_s"] * ls_eq["eval"] \
            * (ph_eq * w_l_eq * w_t_eq)[:, None] \
            * um.safe_divide(1.0, pdf_eq * ls_eq["pdf"], 0.0)[:, None]
        contrib_eq = _clamp_contrib(contrib_eq, clamp_val)
        sh_on_eq = eq_ok & (contrib_eq != 0.0).any(-1)
        sh_tmax_eq = _light_plane_tmax(
            ls_eq, P_eq, ls_eq["D"], ls_eq["dist"],
            torch.clamp(ls_eq["dist"] * (1.0 - 1e-3) - RAY_EPS, min=1e-5))
        bhit_eq, blk_eq = dual_sweep(P_eq, ls_eq["D"], sh_on_eq, sh_on_eq,
                                     sh_tmax_eq, st["time"])
        sh_trans_eq = torch.where(blk_eq[:, None], 0.0, 1.0)
        contrib_eq = contrib_eq * sh_trans_eq
        trans_eq, block_eq = vol_nee_attenuation(vc["sigma_t"], bhit_eq,
                                                 sh_tmax_eq)
        contrib_eq = contrib_eq * trans_eq
        eq_lit = sh_on_eq & ~block_eq & (sh_trans_eq > 0.0).any(-1)
        L = torch.where(eq_lit[:, None], L + contrib_eq, L)
        # the distance-point estimator: MIS-weighted in MIS mode
        pdf_eq_at_td = torch.where(
            pos_light,
            vol_ops.equiangular_pdf(st["o"], st["d"], t_seg_max, ls["P_l"],
                                    dres["t_scatter"]), 0.0)
        pdf_d_at_td = vol_ops.distance_pdf(vc["sigma_t"], thr0,
                                           dres["t_scatter"])
        w_t_d = um.power_heuristic(pdf_d_at_td, pdf_eq_at_td)
        return L, w_t_d, mis_lane, eq_lane & ~mis_lane & eq_ok

    def step(st):
        alive = st["alive"]
        bounce = st["bounce"]
        clamp_val = torch.where(bounce <= 1, clamp_direct, clamp_indirect)

        # ---- per-bounce rng: all four dimension pairs in one call ----
        base = rngu.PRNG_BASE_NUM + bounce.long() * rngu.PRNG_BOUNCE_NUM
        bdims = base[None, :] + torch.tensor(
            [rngu.PRNG_BSDF, rngu.PRNG_LIGHT, rngu.PRNG_TERMINATE,
             rngu.PRNG_PHASE], device=dev)[:, None]
        (bu, lu, rr_u, sel_u), (bv, lv, lobe_u, phase_v) = rng2_batch(
            bdims, st["sample"])

        if fused:
            # the hit this ray was given by the previous union walk (or
            # by seed)
            hit = {k: st["hit_" + k] for k in HIT_KEYS}
        else:
            hit = _scene_intersect_tris(kg, st["o"], st["d"], st["tmin"],
                                        st["tmax"],
                                        vis_of_flag(st["path_flag"]),
                                        time=st["time"])
        found = hit["prim"] >= 0
        L = st["L"]
        throughput = st["throughput"]

        # ---- volume segment ----
        scattered = torch.zeros(n, dtype=torch.bool, device=dev)
        if has_medium:
            vc, dres, scattered, P_scatter, throughput, L = medium_segment(
                st, hit, throughput, L, phase_v, lobe_u)
            vol_g = vc["anisotropy"]

        # ---- area lamps hit by this ray (MIS) ----
        if kg.get("num_area_lamps", 0) > 0:
            light_ops.lamp_hits(ds, kg["lamp_types"], st["o"], st["d"],
                                st["tmax"], None)

        # ---- background ----
        miss = alive & ~found & ~scattered
        bg = shade_ops.eval_background(kg["shaders"],
                                       kg["background_shader"], st["d"],
                                       textures=kg.get("textures"),
                                       path_flag=st["path_flag"])
        contrib = _clamp_contrib(throughput * bg, clamp_val)
        L = torch.where(miss[:, None], L + contrib, L)
        alive = alive & (found | scattered)
        on_surface = alive & ~scattered

        # ---- shading ----
        sd = shade_ops.shader_setup(ds, hit, st["o"], st["d"],
                                    time=st["time"], ray_depth=bounce,
                                    path_flag=st["path_flag"],
                                    textures=kg.get("textures"))
        closures = shade_ops.eval_shaders(kg["shaders"], sd, sd.shader)
        if has_volume:
            # volume-only materials: their surfaces are transparent
            closures["transparent"] = closures["transparent"] \
                + vol_only[torch.clamp(sd.shader, 0, nsh - 1).long()][:, None]
        if has_sss:
            # SSS walk exit: a surface hit from inside ends the walk as a
            # unit diffuse transmission on the outside (the -N side)
            sss_exit = on_surface & st["in_sss"]
            for k in cl.CLOSURE_VEC_KEYS:
                if k == "subsurface_radius":
                    continue
                base_v = 1.0 if k == "diffuse" else 0.0
                closures[k] = torch.where(sss_exit[:, None], base_v,
                                          closures[k])
            sd.N = torch.where(sss_exit[:, None], -sd.N, sd.N)
            sd.Ng = torch.where(sss_exit[:, None], -sd.Ng, sd.Ng)

        # ---- surface emission with MIS ----
        emis = closures["emission"]
        has_emis = (emis > 0.0).any(-1)
        cos_hit = um.dot(sd.Ng, sd.I)
        if has_lights:
            pdf_light = light_ops.triangle_light_pdf(
                ds, (sd.prim_row, sd.object_tfm), hit["t"], cos_hit)
        else:
            pdf_light = torch.zeros_like(st["pdf_prev"])
        w_emis = torch.where(st["singular_prev"], 1.0,
                             um.power_heuristic(st["pdf_prev"], pdf_light))
        contrib = _clamp_contrib(throughput * emis * w_emis[:, None],
                                 clamp_val)
        L = torch.where((on_surface & has_emis)[:, None], L + contrib, L)

        # ---- NEE + MIS (from the surface point or the scatter point) ----
        if has_lights:
            P_nee = torch.where(scattered[:, None], P_scatter, sd.P) \
                if has_medium else sd.P
            ls = light_ops.sample_light(ds, P_nee, sel_u, lu, lv,
                                        static_kinds=kg.get("light_kinds"))
            f_l, pdf_fwd = bsdf_ops.bsdf_eval(closures, sd.N, sd.I, ls["D"],
                                              features)
            if has_medium:
                ph = vol_ops.hg_phase_eval(um.dot(st["d"], ls["D"]), vol_g)
                f_l = torch.where(scattered[:, None], ph[:, None], f_l)
                pdf_fwd = torch.where(scattered, ph, pdf_fwd)
            w_l = torch.where(ls["delta"], 1.0,
                              um.power_heuristic(ls["pdf"], pdf_fwd))
            contrib = throughput * f_l * ls["eval"] \
                * um.safe_divide(w_l, ls["pdf"], 0.0)[:, None]
            contrib = _clamp_contrib(contrib, clamp_val)
            can_light = alive & ls["valid"] & (contrib != 0.0).any(-1)
            # the shadow segment is recomputed from the offset origin
            # toward the sampled light point (scatter points: no offset)
            off = torch.where((um.dot(ls["D"], sd.Ng) > 0)[:, None],
                              sd.Ng, -sd.Ng) \
                * _offset_eps(sd.P, sd.ray_length)[:, None]
            if has_medium:
                off = torch.where(scattered[:, None], 0.0, off)
            sh_o = P_nee + off
            distant = ls["dist"] >= um.RAY_TMAX * 0.5
            P_light = P_nee + ls["D"] * ls["dist"][:, None]
            to_l = P_light - sh_o
            dist2 = torch.clamp(um.length(to_l), min=1e-12)
            sh_d = torch.where(distant[:, None], ls["D"],
                               to_l / dist2[:, None])
            sh_tmax = _light_plane_tmax(
                ls, sh_o, sh_d, dist2,
                torch.where(distant, um.RAY_TMAX,
                            dist2 * (1.0 - 1e-3) - RAY_EPS))
            if fused:
                # deferred to finish: the shadow ray shares the next ray's
                # union walk, and the contribution is added there
                blocked = None
            elif use_dual_shadow:
                in_vol_sh = st["vol_shader"] >= 0
                bhit_sh, blocked = dual_sweep(sh_o, sh_d, can_light,
                                              can_light & in_vol_sh, sh_tmax,
                                              st["time"])
                contrib = contrib * torch.where(blocked[:, None], 0.0, 1.0)
                # in a medium: attenuate to the boundary; a surface before
                # it blocks, the boundary itself does not
                trans, vol_block = vol_nee_attenuation(vc["sigma_t"],
                                                       bhit_sh, sh_tmax)
                contrib = torch.where(in_vol_sh[:, None], contrib * trans,
                                      contrib)
                blocked = torch.where(in_vol_sh, vol_block, blocked)
            else:
                tmin_sh = torch.full((n,), 1e-5, device=dev)
                blocked = _shadow_blocked(
                    kg, sh_o, sh_d, tmin_sh,
                    torch.where(can_light, sh_tmax, tmin_sh), time=st["time"])
                contrib = contrib * torch.where(blocked[:, None], 0.0, 1.0)
            if has_equiangular:
                L, w_t_d, mis_lane, replaced = equiangular_nee(
                    st, hit, ls, vc, vol_g, dres, sel_u, lu, lv, clamp_val,
                    L)
                contrib = torch.where((scattered & mis_lane)[:, None],
                                      contrib * w_t_d[:, None], contrib)
                can_light = can_light & ~(scattered & replaced)
            if not fused:
                L = torch.where((can_light & ~blocked)[:, None], L + contrib,
                                L)

        # ---- BSDF bounce (phase function at scatter points) ----
        bs = bsdf_ops.bsdf_sample(closures, sd.N, sd.Ng, sd.I, bu, bv,
                                  lobe_u, features)
        if has_medium:
            ph_dir, ph_pdf = vol_ops.hg_phase_sample(st["d"], vol_g, bu, bv)
            # HG is importance sampled exactly: f == pdf
            bs = {"omega": torch.where(scattered[:, None], ph_dir,
                                       bs["omega"]),
                  "f_cos": torch.where(scattered[:, None], ph_pdf[:, None],
                                       bs["f_cos"]),
                  "pdf": torch.where(scattered, ph_pdf, bs["pdf"]),
                  "valid": torch.where(scattered, ph_pdf > 0.0, bs["valid"]),
                  "label": torch.where(scattered,
                                       bsdf_ops.LABEL_VOLUME_SCATTER,
                                       bs["label"]).to(torch.int32)}
        if has_sss:
            # SSS walk entry: pick the subsurface lobe against the rest
            # and dive in on a cosine direction through the surface; the
            # walk's medium follows the Christensen-Burley albedo
            # inversion for burley falloff, else sigma_t = 1 / radius
            sss_w = closures["subsurface"].abs().mean(-1)
            rest_w = bsdf_ops._lobe_probs(closures, include_sss=False)[-1]
            p_entry = um.safe_divide(sss_w, sss_w + rest_w, 0.0)
            entry = on_surface & ~st["in_sss"] & (phase_v < p_entry) \
                & (sss_w > 1e-12)
            d_in, pdf_in = um.sample_cos_hemisphere(-sd.N, bu, bv)
            is_burley = closures["subsurface_burley"] > 0.0
            A_c = torch.clamp(closures["subsurface"], 0.0, 0.999)
            alpha_w = 1.0 - torch.exp(
                A_c * (-5.09406 + A_c * (2.61188 - 4.31805 * A_c)))
            s_scale = 1.9 - A_c + 3.5 * (A_c - 0.8) ** 2
            entry_color = torch.where(is_burley[:, None], 1.0,
                                      closures["subsurface"])
            keep = on_surface & ~st["in_sss"] & ~entry & (sss_w > 1e-12)
            pdf = torch.where(entry, pdf_in * torch.clamp(p_entry, min=1e-12),
                              bs["pdf"])
            bs = {"omega": torch.where(entry[:, None], d_in, bs["omega"]),
                  "f_cos": torch.where(entry[:, None],
                                       entry_color * pdf_in[:, None],
                                       bs["f_cos"]),
                  # non-entry lanes keep their (1 - p_entry) pick weight
                  "pdf": torch.where(
                      keep, pdf * torch.clamp(1.0 - p_entry, min=1e-12), pdf),
                  "valid": torch.where(entry, pdf_in > 0.0, bs["valid"]),
                  "label": torch.where(entry, bsdf_ops.LABEL_TRANSMIT,
                                       bs["label"]).to(torch.int32)}

        new_throughput = throughput * bs["f_cos"] \
            * um.safe_divide(1.0, bs["pdf"], 0.0)[:, None]
        alive2 = alive & bs["valid"] \
            & (new_throughput.abs() > 1e-7).any(-1)
        label = bs["label"]
        is_diff = (label & bsdf_ops.LABEL_DIFFUSE) > 0
        is_gloss = (label & bsdf_ops.LABEL_GLOSSY) > 0
        is_trans = (label & bsdf_ops.LABEL_TRANSMIT) > 0
        is_transp = (label & bsdf_ops.LABEL_TRANSPARENT) > 0
        is_sing = (label & bsdf_ops.LABEL_SINGULAR) > 0
        dd = st["diffuse_depth"] + is_diff.to(torch.int32)
        gd = st["glossy_depth"] + is_gloss.to(torch.int32)
        td = st["transmission_depth"] + is_trans.to(torch.int32)
        pd = st["transparent_depth"] + is_transp.to(torch.int32)
        alive2 &= dd <= int(kint["max_diffuse_bounce"])
        alive2 &= gd <= int(kint["max_glossy_bounce"])
        alive2 &= td <= int(kint["max_transmission_bounce"])
        alive2 &= pd <= int(kint["transparent_max_bounce"])
        alive2 &= bounce + 1 <= max_bounce

        # ---- russian roulette ----
        p_cont = torch.clamp(new_throughput.abs().amax(-1), 0.0, 1.0)
        p_cont = torch.where(bounce >= min_bounce, p_cont, 1.0)
        alive2 &= rr_u < p_cont
        new_throughput = new_throughput \
            * um.safe_divide(1.0, p_cont, 0.0)[:, None]

        # ---- next ray ----
        out_side = um.dot(bs["omega"], sd.Ng) > 0.0
        off = torch.where(out_side[:, None], sd.Ng, -sd.Ng) \
            * _offset_eps(sd.P, sd.ray_length)[:, None]
        new_o = sd.P + off
        flag = st["path_flag"]
        new_flag = torch.where(
            is_transp, flag,
            (flag & ~ob.PATH_RAY_CAMERA)
            | torch.where(is_diff, ob.PATH_RAY_DIFFUSE, 0)
            | torch.where(is_gloss, ob.PATH_RAY_GLOSSY | ob.PATH_RAY_REFLECT,
                          0)
            | torch.where(is_trans, ob.PATH_RAY_TRANSMIT, 0)
            | torch.where(is_sing, ob.PATH_RAY_SINGULAR, 0)
        ).to(torch.int32)
        if has_medium:
            new_o = torch.where(scattered[:, None], P_scatter, new_o)
            new_flag = torch.where(scattered,
                                   flag | ob.PATH_RAY_VOLUME_SCATTER,
                                   new_flag).to(torch.int32)
        out = {
            "o": torch.where(alive2[:, None], new_o, st["o"]),
            "d": torch.where(alive2[:, None], bs["omega"], st["d"]),
            "tmin": torch.full((n,), 1e-5, device=dev),
            "tmax": torch.full((n,), um.RAY_TMAX, device=dev),
            "time": st["time"],
            "throughput": torch.where(alive2[:, None], new_throughput,
                                      throughput),
            "L": L,
            "alpha": st["alpha"],
            "alive": alive2,
            "pdf_prev": torch.where(is_sing, st["pdf_prev"], bs["pdf"]),
            "singular_prev": is_sing,
            "path_flag": new_flag,
            "diffuse_depth": dd, "glossy_depth": gd,
            "transmission_depth": td, "transparent_depth": pd,
            "bounce": bounce + 1,
            "sample": st["sample"],
        }
        if has_volume:
            # the volume stack at transmissive surface crossings: entering
            # a volume shader pushes it, exiting removes the first entry
            # of the crossed shader (deeper entries shift up)
            crossing = (is_trans | is_transp) & on_surface & alive2
            entering = crossing \
                & shader_vol[torch.clamp(sd.shader, 0, nsh - 1).long()] \
                & ~sd.backfacing
            exiting = crossing & sd.backfacing
            stack = torch.cat([st["vol_shader"][:, None], st["vol_rest"]], 1)
            pushed = torch.cat([sd.shader[:, None], stack[:, :-1]], 1)
            match = stack == sd.shader[:, None]
            # entries at and below the first match (argmax: first True)
            first = match.to(torch.int8).argmax(1, keepdim=True)
            seen = match.any(1, keepdim=True) \
                & (torch.arange(stack.shape[1], device=dev)[None] >= first)
            shifted = torch.cat([stack[:, 1:], torch.full_like(
                stack[:, :1], -1)], 1)
            popped = torch.where(seen, shifted, stack)
            new_stack = torch.where(entering[:, None], pushed,
                                    torch.where(exiting[:, None], popped,
                                                stack))
            out["vol_shader"] = new_stack[:, 0].contiguous()
            out["vol_rest"] = new_stack[:, 1:].contiguous()
        if has_sss:
            radius = torch.clamp(closures["subsurface_radius"], 1e-5, 1e8)
            out["in_sss"] = ((st["in_sss"] & ~sss_exit) | entry) & alive2
            sigma_entry = torch.where(
                is_burley[:, None],
                1.0 / torch.clamp(radius * s_scale, 1e-5, 1e8),
                1.0 / radius)
            out["sss_sigma_t"] = torch.where(entry[:, None], sigma_entry,
                                             st["sss_sigma_t"])
            out["sss_albedo"] = torch.where(
                entry[:, None], torch.where(is_burley[:, None], alpha_w, 1.0),
                st["sss_albedo"])
        if fused:
            # has_lights holds in fused mode; sh_tmax -1 (an empty window)
            # where there is nothing to test
            return out, {"sh_o": sh_o, "sh_d": sh_d,
                         "sh_tmax": torch.where(can_light, sh_tmax, -1.0),
                         "can_light": can_light, "contrib": contrib}
        return out

    if not fused:
        return start_paths, step

    def seed(st):
        """The camera rays' closest hits (the any-hit ray disabled)."""
        vis0 = vis_of_flag(st["path_flag"])
        empty = torch.full((n,), -1.0, device=dev)
        hit, _blocked = _dual_walk(
            kg, st["o"], st["d"], st["tmin"],
            torch.where(st["alive"], st["tmax"], empty), vis0,
            st["o"], st["d"], empty, vis0)
        st = dict(st)
        for k in HIT_KEYS:
            st["hit_" + k] = hit[k]
        return st

    def finish(out, pend, regen_mask=None, regen_st=None):
        """One union walk: the deferred NEE shadow test of this bounce and
        the closest hit of the next ray; then the NEE contribution. Under
        regen_mask a finished lane's next ray is its new sample's camera
        ray (regen_st), so it shares this walk; the contribution still
        lands in the finished sample's L.

        A regenerated lane's ray is traced inside its new sample's own
        window, [regen_st tmin, min(regen_st tmax, RAY_TMAX)], which is
        what seed and the unfused loops give the same camera ray. The
        JAX package passes 1e-5 and the finished path's tmax there, which
        lets a regenerated sample see past the camera's far clip (or miss
        what lies nearer than 1e-5) where its fixed-grid render does
        not."""
        o_c, d_c = out["o"], out["d"]
        vis_c = vis_of_flag(out["path_flag"])
        alive_c = out["alive"]
        tmin_c = torch.full((n,), 1e-5, device=dev)
        tmax_c = torch.clamp(out["tmax"], max=um.RAY_TMAX)
        if regen_mask is not None:
            o_c = torch.where(regen_mask[:, None], regen_st["o"], o_c)
            d_c = torch.where(regen_mask[:, None], regen_st["d"], d_c)
            vis_c = torch.where(regen_mask,
                                vis_of_flag(regen_st["path_flag"]), vis_c)
            alive_c = alive_c | regen_mask
            tmin_c = torch.where(regen_mask, regen_st["tmin"], tmin_c)
            tmax_c = torch.where(
                regen_mask, torch.clamp(regen_st["tmax"], max=um.RAY_TMAX),
                tmax_c)
        tmax_c = torch.where(alive_c, tmax_c, -1.0)
        hit, blocked = _dual_walk(
            kg, o_c, d_c, tmin_c, tmax_c, vis_c, pend["sh_o"], pend["sh_d"],
            pend["sh_tmax"], i32(ob.PATH_RAY_SHADOW))
        out = dict(out)
        out["L"] = torch.where((pend["can_light"] & ~blocked)[:, None],
                               out["L"] + pend["contrib"], out["L"])
        for k in HIT_KEYS:
            out["hit_" + k] = hit[k]
        return out

    return start_paths, step, seed, finish


def _trace_sample(kern, n, max_bounce, sample, dev):
    """One sample of every lane on the fixed grid: max_bounce + 1 steps."""
    samples = torch.full((n,), int(sample), dtype=torch.int64, device=dev)
    if len(kern) == 4:
        # fused NEE: the camera hit from seed, then one union walk a bounce
        start_paths, step, seed, finish = kern
        st = seed(start_paths(samples))
        for _ in range(max_bounce + 1):
            st = finish(*step(st))
    else:
        start_paths, step = kern
        st = start_paths(samples)
        for _ in range(max_bounce + 1):
            st = step(st)
    return st["L"], st["alpha"]


def path_trace_sample(kg, px, py, pixel_index, sample):
    """Trace one sample for a wavefront of pixels on the fixed-depth grid.
    Returns (radiance (N, 3), alpha (N,), aux dict); the aux dict is empty
    (aux passes are not ported)."""
    kern = make_path_kernel(kg, px, py, pixel_index)
    L, alpha = _trace_sample(kern, px.shape[0],
                             int(kg["kint"]["max_bounce"]), sample, px.device)
    return L, alpha, {}


def render_samples(kg, px, py, pixel_index, sample_start, num_samples):
    """Accumulate `num_samples` consecutive samples on the fixed grid.
    Returns (radiance sum (N, 3), alpha sum (N,))."""
    kern = make_path_kernel(kg, px, py, pixel_index)
    max_bounce = int(kg["kint"]["max_bounce"])
    L, A = _trace_sample(kern, px.shape[0], max_bounce, sample_start,
                         px.device)
    for i in range(1, num_samples):
        rad, alpha = _trace_sample(kern, px.shape[0], max_bounce,
                                   int(sample_start) + i, px.device)
        L, A = L + rad, A + alpha
    return L, A


def _regen_loop(kg, px, py, pixel_index, s0, per_lane, stride, even=False):
    """The regenerating wavefront: every lane renders `per_lane` samples
    of its pixel, s0, s0 + stride, ..., starting the next one as soon as
    the path of the last one has ended. Returns the per-lane sums
    (L (N, 3), A (N,), E): E sums the samples of even index when `even`,
    else it is None.

    Unfused, a dead lane is merged and regenerated before the step. In
    fused-NEE mode that happens after the shading half of the bounce, so
    the dying lane's deferred shadow ray and its new sample's camera ray
    share one union walk; the bounce's NEE contribution stays the last
    addition to L of its bounce, which keeps the sums equal to the fixed
    grid's to the bit in either mode."""
    kern = make_path_kernel(kg, px, py, pixel_index)
    fused = len(kern) == 4
    start_paths, step = kern[:2]
    n, dev = px.shape[0], px.device
    st = start_paths(s0)
    if fused:
        seed, finish = kern[2:]
        st = seed(st)
    L_acc = torch.zeros((n, 3), device=dev)
    A_acc = torch.zeros(n, device=dev)
    E_acc = torch.zeros((n, 3), device=dev) if even else None
    done = torch.zeros(n, dtype=torch.int32, device=dev)
    fresh = torch.ones(n, dtype=torch.bool, device=dev)
    while bool((st["alive"] | fresh | (done < per_lane)).any()):
        if fused:
            out, pend = step(st)
            merge = ~out["alive"] & fresh
            regen = merge & (done + 1 < per_lane)
            new_st = start_paths(torch.where(regen, out["sample"] + stride,
                                             out["sample"]))
            ended = finish(out, pend, regen, new_st)
        else:
            ended = st
            merge = ~st["alive"] & fresh
        L_acc = L_acc + torch.where(merge[:, None], ended["L"], 0.0)
        A_acc = A_acc + torch.where(merge, ended["alpha"], 0.0)
        if even:
            is_even = merge & (ended["sample"] % 2 == 0)
            E_acc = E_acc + torch.where(is_even[:, None], ended["L"], 0.0)
        done = done + merge.to(torch.int32)
        fresh = fresh & ~merge
        if fused:
            st = {k: _sel(regen, new_st[k], ended[k]) for k in new_st}
            for k in HIT_KEYS:
                st["hit_" + k] = ended["hit_" + k]
            fresh = fresh | regen
        else:
            regen = ~st["alive"] & ~fresh & (done < per_lane)
            new_st = start_paths(torch.where(regen, st["sample"] + stride,
                                             st["sample"]))
            st = {k: _sel(regen, new_st[k], st[k]) for k in st}
            fresh = fresh | regen
            st = step(st)
    return L_acc, A_acc, E_acc


def render_samples_regen(kg, px, py, pixel_index, sample_start, num_samples,
                         lanes_per_pixel=1):
    """Path-regeneration renderer: a dead lane immediately starts its
    pixel's next sample, so the wavefront stays full. Returns (radiance
    sum (npix, 3), alpha sum (npix,)) over `num_samples` samples starting
    at `sample_start`, equal to render_samples' to the bit.

    lanes_per_pixel=K > 1 runs K samples of each pixel at once (lane k
    covers samples start+k, start+k+K, ...); callers pass px, py and
    pixel_index tiled K times."""
    K = int(lanes_per_pixel)
    assert num_samples % K == 0, "lanes_per_pixel must divide num_samples"
    n = px.shape[0]
    assert n % K == 0
    npix = n // K
    s0 = int(sample_start) + torch.arange(
        K, device=px.device).repeat_interleave(npix)
    L_acc, A_acc, _E = _regen_loop(kg, px, py, pixel_index, s0,
                                   num_samples // K, K)
    if K == 1:
        return L_acc, A_acc
    return (L_acc.reshape(K, npix, 3).sum(0), A_acc.reshape(K, npix).sum(0))


def render_samples_adaptive_chunk(kg, px, py, pixel_index, sample_start,
                                  num_samples):
    """One chunk of the adaptive sampler: which pixel a lane renders and
    at which sample it starts are data (`sample_start` is a per-lane
    tensor), so converged pixels' lanes can be handed to pixels that are
    still active. Each lane renders `num_samples` consecutive samples of
    its pixel. Returns per-lane (L sum, A sum, L sum over the samples of
    even index): the caller adds lanes into the framebuffer by pixel id,
    and the even-sample sum feeds the half-buffer error estimate."""
    return _regen_loop(kg, px, py, pixel_index,
                       torch.as_tensor(sample_start, device=px.device).long(),
                       int(num_samples), 1, even=True)


def _sel(mask, a, b):
    m = mask
    while m.ndim < a.ndim:
        m = m[..., None]
    return torch.where(m, a, b)
