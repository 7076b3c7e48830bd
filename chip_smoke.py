"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's seven main paths (raytracingproject_tpu_torch) and its
adaptive loop on the card and fails (nonzero exit, no result line) if any
phase fails:

1. environment: CUDA present; card name and power limit (nvidia-smi),
   torch and CUDA versions; TF32 off (raytracingproject_tpu_torch.device);
2. build: the hand-written kernels compiled from csrc/*.cu, one nvcc call
   per source, all started together;

glossy_nee_mis (the Cornell box with a GGX sphere; K2 and K3):

3. kernels vs plain versions on the glossy scene's tables: K2 closest and
   any hit, K3 in its surface form and in its dual form (with a seeded
   random volume-boundary table planted, so both minima are exercised),
   and K4 closest and any hit (C = 179), on 65,536 random rays and 65,536
   camera rays;
4. accuracy: 64x64, 128 spp, chunk 16, clamp off, rendered on the card
   and held against the float64 twin render artifacts/twin_f64.npz (rmse
   <= 5.7e-5, <= 0.07% of pixels off by more than 1e-3);
5. full width: 512x512, 64 spp, chunk 16, 1 lane per pixel through the
   CLI code path; the image must be finite with a mean within 0.5% of the
   JAX package's mean for the same render (JAX_MEAN_512), and K2 and K3
   must have been launched by this render. The inputs of the third call
   of each kernel (262,144 lanes; camera, diffuse and glossy visibility
   mixed) are copied as the render runs;
6. main-path shapes: at 262,144 lanes each kernel is held against its
   plain version and both are timed, on the inputs copied from the render
   and on camera rays / NEE-like shadow rays;

volume_sss (homogeneous smoke and a random-walk SSS sphere in the Cornell
box, with the dispatch the configuration pins: K4 and K3's dual form):

7. kernels vs plain versions on the volume_sss tables: K4 closest and any
   hit, K3's dual form with the scene's real volume-boundary table, on
   65,536 random rays and 65,536 camera rays;
8. accuracy: 64x64, 128 spp, chunk 16, clamp off, against
   twin_f64.npz["volume_sss"] (rmse <= 1.15e-4, <= 0.15% of pixels off by
   more than 1e-3: twice the JAX package's own float32 render);
9. full width: 256x256, 32 spp, chunk 16 through the CLI code path
   (example:volume_sss); finite, mean within 1% of the JAX package's mean
   for the same render (JAX_MEAN_VOL_256), K4 and K3 launched by this
   render; the inputs of each kernel's third call are copied;
10. main-path shapes: at 65,536 lanes K4 (on the copied input and on
   camera rays) and K3's dual form (on the copied input) are held against
   their plain versions and both are timed;

big_instanced (64 instances of one image-textured sphere on a checkered
ground plane, a distant sun and a constant sky; two-level cluster tables:
K5 for every closest hit and every NEE shadow test):

11. kernels vs plain versions on the scene's tables (1,025 clusters in 65
   superclusters, instance rows): K5 closest and any hit on 65,536 random
   rays from inside the scene's bounds and 65,536 camera rays; hit masks
   equal, max |dt| 0 off exact ties, tie lanes held to an exact tie;
12. accuracy: 64x64, 128 spp, chunk 16, clamp off, against the float64
   twin raytracingproject_tpu_torch/data/twin_big_instanced.npz (made
   once on the CPU with the JAX package by tools/rmse_twin.py's method,
   `python -m tests.test_torch_instanced_render twin f32|f64`; it also
   holds the JAX package's own float32 render): rmse and the share
   of pixels off by more than 1e-3 at most twice the JAX render's own;
13. full width: 256x256, 16 spp, chunk 8 through the CLI code path
   (example:big_instanced); finite, mean within 0.5% of the JAX package's
   mean for the same render (JAX_MEAN_BIG_256), K5 launched by this
   render; the inputs of K5's third call (the second iteration's closest
   hit) are copied;
14. main-path shapes: at 65,536 lanes K5 on the copied input (closest) and
   on sun shadow rays from the camera rays' first hits (any hit) is held
   against its plain version and both are timed.

cornell_diffuse (the Cornell box with its two boxes, 36 prims: the dense
sweep K1 for every closest hit and, in its any-hit mode, every NEE shadow
test):

15. K1's closest, any-hit, dual and Moeller-Trumbore modes vs their plain
   versions (ops/intersect.py) on the scene's 36 triangles (a seeded
   boundary mask planted for the dual form), 65,536 random rays with mixed
   per-lane visibility and 65,536 camera rays: prims, t, u, v equal to
   the bit, masks equal;
16. accuracy: 64x64, 128 spp, chunk 16, clamp off, against
   twin_f64.npz["cornell_diffuse"] (rmse <= 5.7e-5, <= 0.07% of pixels off
   by more than 1e-3);
17. full width: 512x512, 64 spp, chunk 32 through the CLI code path
   (example:cornell); finite, mean within 0.5% of the JAX package's mean
   for the same render (JAX_MEAN_CORNELL_512), K1's closest and any-hit
   modes launched by this render; the inputs of each mode's third call
   are copied;
18. main-path shapes: at 262,144 lanes the two modes are held against
   their plain versions on the copied inputs and timed, and so is the
   Moeller-Trumbore mode on the copied closest-hit rays;

volume_sss under the host compile's own dispatch (1,008 prims: K1 for
every closest hit and, in its dual form, both volume-NEE sweeps):

19. K1's four modes vs their plain versions on the scene's 1,008
   triangles and its real boundary mask, as in 15;
20. accuracy: 64x64, 128 spp against twin_f64.npz["volume_sss"] under
   volume_sss's gate;
21. full width: 256x256, 32 spp, chunk 16 (example:volume_sss:dense);
   mean within 1% of JAX_MEAN_VOL_256, K1's closest mode and dual form
   launched; third calls copied;
22. main-path shapes: at 65,536 lanes the closest mode, the dual form and
   the Moeller-Trumbore mode on the copied inputs, held and timed;

big_instanced with pallas_onehot2 (K6 for every closest hit and shadow
test):

23. K6 vs its plain version as K5 in 11;
24. full width: 256x256, 16 spp, chunk 8 (example:big_instanced:onehot2);
   mean within 0.5% of JAX_MEAN_BIG_256, K6 launched; third call copied;
25. main-path shapes: at 65,536 lanes K6 on the copied closest-hit input
   and on sun shadow rays, held and timed, and K5 timed on the same copied
   input beside it.

glossy_nee_mis in fused-NEE mode (examples.GLOSSY_FUSED: the union walk K7
answers every closest hit and every NEE shadow test; K2 and K3 are not
called):

26. K7 vs its plain version (ops/cluster_intersect.py
   intersect_clusters_dual) on the glossy tables: 65,536 random closest
   rays with mixed per-lane visibility paired with any-hit rays from nearby
   origins toward the lamp, 65,536 camera rays paired with NEE-like shadow
   rays, and each ray of the random pairs switched off by an empty window;
   blocked equal everywhere, the closest hit equal off exact-t ties, tie
   lanes held to an exact tie;
27. accuracy: 64x64, 128 spp, chunk 16, clamp off, fused, against
   twin_f64.npz["glossy_nee_mis"] under glossy's gate; K7 launched;
28. full width: 512x512, 64 spp, chunk 16 through the CLI code path
   (example:cornell:glossy:fused); finite, mean within 0.5% of
   JAX_MEAN_512, K7 launched and K2 and K3 launched 0 times by this
   render; the inputs of K7's third call (262,144 lanes) are copied;
29. main-path shapes: at 262,144 lanes K7 on the copied input is held
   against its plain version and timed; beside it, on the same copied
   rays, K2 (the closest half) and K3 (the any-hit half), which is what
   the fused call replaces;
30. adaptive loop (session/adaptive.py render_adaptive_device): glossy
   256x256, 32 spp, chunk 4, unfused and fused, once with threshold 0
   (every count equals 32, image mean within 0.5% of the fixed render's at
   that size) and once with threshold 0.02 (converged, fewer samples than
   nominal, mean within 1%); the fused runs launch K7 only, the unfused
   ones K2 and K3 only.

Launch counts are set to 0 just before each full-width render and read
just after it; the launches of the comparisons do not count. Each
kernel's bound (the least time the card could take for the same work) is
computed from the inputs of its timed call: the larger of the bytes it
must move over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
H100 SXM's published peaks). The script takes about 5 minutes, the
kernels' build included.

The last three lines are the card's name and power limit, a JSON line
describing each kernel, and {"ok": true, "device": {...}}.
"""

import contextlib
import importlib
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
N_CHECK = 65536
# which call of each kernel wrapper a full-width render has its inputs
# copied from: by the third wavefront iteration the lanes mix camera
# rays (regenerated paths) with bounce rays
RECORD_CALL = 3
TWIN = "artifacts/twin_f64.npz"
TWIN_F32 = "artifacts/twin_f32.npz"
TIE_FRAC = 1e-4
# volume_sss's Cornell box has two boxes whose bottom faces lie in the
# floor's plane: a ray from below the floor (a quarter of the random rays)
# that meets them hits two coplanar triangles at one t, and the walks'
# visit orders pick different ones. Every such lane is still held to an
# exact tie (t within 1e-6 relative + 1e-4); only their share may be
# larger there.
TIE_FRAC_COPLANAR = 2e-3
# Image means of the JAX package's own render of each full-width cell
# (render_samples_regen on the CPU, chunks of 16, default clamp 10,
# averaged in float64): glossy 512x512x64 and volume_sss 256x256x32. The
# 64x64 twins' means are not the reference here: in both packages the
# image mean moves with resolution (glossy 64x64 0.1727 -> 256x256 0.1784
# at clamp 0).
JAX_MEAN_512 = 0.17757781157033317
JAX_MEAN_VOL_256 = 0.2115986647204958
# big_instanced 256x256x16, chunks of 8, default clamp (the JAX package's
# render_samples_regen on the CPU, which walks its packed BVH there;
# python -m tests.test_torch_instanced_render mean 256 16 8)
JAX_MEAN_BIG_256 = 0.21052450607052078
TWIN_BIG = "raytracingproject_tpu_torch/data/twin_big_instanced.npz"
# cornell_diffuse 512x512x64, chunks of 32, default clamp (the JAX
# package's render_samples_regen on the CPU through its dense sweep;
# python -m tests.test_torch_dense_render mean 512 64 32)
JAX_MEAN_CORNELL_512 = 0.16585140399495943
# the wrappers: kernel name -> (module under ops/, function)
WRAPPERS = {
    "cluster_walk": ("cluster_walk", "intersect_clusters_walk"),
    "occlusion_walk": ("occlusion_walk", "occlusion_clusters_walk"),
    "tile_walk": ("tile_walk", "intersect_clusters_tile"),
    "cluster2_walk": ("cluster2_walk", "intersect_clusters2_walk"),
    "onehot2_walk": ("onehot2_walk", "intersect_clusters2_onehot"),
    "dual_walk": ("dual_walk", "intersect_clusters_dual_walk"),
    "dense_closest": ("dense_sweep", "intersect_brute_sweep"),
    "dense_any": ("dense_sweep", "shadow_blocked_sweep"),
    "dense_dual": ("dense_sweep", "occlusion_sweep"),
    "dense_mt": ("dense_sweep", "intersect_mt_sweep"),
}
# K1's wrappers count launches per mode, in one dict
DENSE_MODE = {"dense_closest": "closest", "dense_any": "any",
              "dense_dual": "dual", "dense_mt": "mt"}
# the plain version of each of them, in ops/intersect.py
DENSE_PLAIN = {"dense_closest": "intersect_brute",
               "dense_any": "shadow_blocked_brute",
               "dense_dual": "intersect_brute_occlusion",
               "dense_mt": "intersect_brute_mt"}
# operation counts of the walks' two tests (float32 arithmetic and
# comparisons, counted from csrc/watertight.cuh) and the card's peaks
SLAB_OPS = 27      # slab_entry: one ray against one cluster box
TRI_OPS = 110      # wt_tri_v: one ray against one triangle
# K5 per instance row a lane visits: the w2o transform of origin and
# direction (33, csrc/cluster2_walk.cu) and a new shear basis (68,
# wt_setup in csrc/watertight.cuh)
XFORM_OPS = 33 + 68
# one ray against one triangle in Moeller-Trumbore arithmetic (counted from
# csrc/dense_sweep.cu dense_mt_kernel)
MT_OPS = 56
# the adaptive phase: glossy at ADAPTIVE_SIZE^2, and the threshold of the
# run that stops pixels early
ADAPTIVE_SIZE, ADAPTIVE_SPP, ADAPTIVE_CHUNK = 256, 32, 4
ADAPTIVE_THRESHOLD = 0.02
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def module(name):
    return importlib.import_module(
        f"raytracingproject_tpu_torch.ops.{WRAPPERS[name][0]}")


def wrapper(name):
    return getattr(module(name), WRAPPERS[name][1])


def launches_of(name):
    count = module(name).launches
    return count[DENSE_MODE[name]] if name in DENSE_MODE else count


def reset_launches():
    for name in WRAPPERS:
        mod = module(name)
        if name in DENSE_MODE:
            mod.launches[DENSE_MODE[name]] = 0
        else:
            mod.launches = 0


def median_ms(fn, reps):
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def random_rays(n, rng, dev, lo=(-300,) * 3, hi=(900,) * 3):
    """Rays as in the JAX package's one-hot walk tests: origins uniform
    in a box around the scene (lo, hi), isotropic directions."""
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, device=dev), torch.tensor(d, device=dev))


def camera_rays(kg, width, height, dev):
    """Pixel-center camera rays of a width x height film."""
    from raytracingproject_tpu_torch.ops import camera as cam_ops
    cam = dict(kg["cam"])
    sx, sy = width / float(cam["width"]), height / float(cam["height"])
    yy, xx = np.mgrid[0:height, 0:width]
    rx = torch.tensor((xx.reshape(-1) + 0.5) / sx, dtype=torch.float32,
                      device=dev)
    ry = torch.tensor((yy.reshape(-1) + 0.5) / sy, dtype=torch.float32,
                      device=dev)
    z = torch.zeros_like(rx)
    ray = cam_ops.camera_sample_ray(cam, rx, ry, z, z, z)
    return ray["o"].contiguous(), ray["d"].contiguous()


def compare_hits(name, ref, got, tie_frac=TIE_FRAC):
    """Hit masks equal; prim/object equal except exact-t ties (t within
    rtol 1e-6 + atol 1e-4; at most tie_frac of the lanes); t rtol 1e-5,
    u/v atol 1e-5 on the lanes that agree. Returns max |t| error on those
    lanes."""
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    assert np.array_equal(ref["prim"] >= 0, got["prim"] >= 0), \
        f"{name}: hit masks differ"
    same = (ref["prim"] == got["prim"]) & (ref["object"] == got["object"])
    tie = ~same
    if tie.any():
        # a differing winner must be an exact tie in t: the two hits' t
        # round in the ray's shear frame, so agree to ~1 ulp of the
        # scene's coordinates (1e-4 at ~556) beside 1e-6 relative
        assert np.allclose(ref["t"][tie], got["t"][tie], rtol=1e-6,
                           atol=1e-4), f"{name}: prims differ off an exact tie"
    frac = float(tie.mean())
    assert frac <= tie_frac, f"{name}: {frac} of lanes differ in prim"
    np.testing.assert_allclose(got["t"][same], ref["t"][same], rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["u"][same], ref["u"][same], atol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["v"][same], ref["v"][same], atol=1e-5,
                               err_msg=name)
    err = float(np.abs(got["t"][same] - ref["t"][same]).max())
    tie_rel = float((np.abs(got["t"][tie] - ref["t"][tie])
                     / np.abs(ref["t"][tie])).max()) if tie.any() else 0.0
    log(f"[kernels] {name}: {len(same)} lanes, hit "
        f"{float((ref['prim'] >= 0).mean()):.4f}, tie lanes "
        f"{int(tie.sum())} (max relative dt {tie_rel:.2e}), max |dt| "
        f"{err:.3e} on the others")
    return err


def compare_any_hit(name, ref, got):
    """Any hit: the blocked masks (prim >= 0) are equal."""
    assert torch.equal(ref["prim"] >= 0, got["prim"] >= 0), \
        f"{name}: blocked masks differ"
    log(f"[kernels] {name}: {ref['prim'].shape[0]} lanes, masks equal, hit "
        f"{float((got['prim'] >= 0).float().mean()):.4f}")
    return 0.0


def compare_walk(name, ref, got, any_hit, tie_frac=TIE_FRAC):
    if any_hit:
        return compare_any_hit(name, ref, got)
    return compare_hits(name, ref, got, tie_frac)


def compare_occlusion(name, ref, got, need_boundary=False):
    """K3: blocked masks equal; t_boundary and t_other within rtol 1e-5.
    Returns the max |t| error over both minima."""
    (rb, ro, rblk), (gb, go, gblk) = ref, got
    assert torch.equal(rblk, gblk), f"{name}: blocked masks differ"
    err = 0.0
    for nm, a, b in (("t_boundary", rb, gb), ("t_other", ro, go)):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   rtol=1e-5, err_msg=f"{name} {nm}")
        err = max(err, float((b - a).abs().max()))
    nb = float((rb < 1e29).float().mean())
    if need_boundary:
        assert nb > 0.0, f"{name}: no lane found a boundary prim"
    log(f"[kernels] {name}: {rb.shape[0]} lanes, blocked equal "
        f"({float(gblk.float().mean()):.4f} blocked), t_boundary found "
        f"{nb:.4f}, t_other found {float((ro < 1e29).float().mean()):.4f}, "
        f"max |dt| {err:.3e}")
    return err


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _prims_per_cluster(ctable, ct):
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    pb = ci.META_COLS + 9 * ct
    return (ctable[:, pb:pb + ct] >= 0).sum(1).to(torch.float64)


def walk_bound(args, kw, out):
    """(bound ms, bound_by) of one closest- or any-hit walk call (K2, K4).
    Bytes: tables, rays and results once. Operations: every lane tests
    every cluster box once; a closest-hit lane tests the triangles of each
    cluster it enters before its final t (a miss: every cluster it
    enters); an any-hit lane that hits tests one triangle."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    cb, ctab, ct, o, d, tmin, tmax, vis = args[:8]
    any_hit = bool(kw.get("shadow_any_hit", False))
    entry = ci.entry_table(cb, o, d, tmin, tmax)
    entered = entry < ci.INF
    if not any_hit:
        entered = entered & (entry < out["t"][None])
    tris = (entered.to(torch.float64)
            * _prims_per_cluster(ctab, int(ct))[:, None]).sum(0)
    if any_hit:
        tris = torch.where(out["prim"] >= 0, 1.0, tris)
    n, c = o.shape[0], cb.shape[0]
    ops = n * c * SLAB_OPS + float(tris.sum()) * TRI_OPS
    return _bound(_nbytes(cb, ctab, o, d, tmin, tmax, vis,
                          *out.values()), ops)


def occlusion_bound(args, out):
    """(bound ms, bound_by) of one K3 call: every lane tests every cluster
    box once and the triangles of each cluster it enters below its final
    gate (a blocked lane at least one triangle)."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    cb, ctab, cbd, ct, o, d, tmin, tmaxc, tmaxa = args[:9]
    t_b, t_o, blocked = out
    entry = ci.entry_table(cb, o, d, tmin, torch.maximum(tmaxc, tmaxa))
    gate = ci.occlusion_gate(t_b, t_o, blocked, tmaxc, tmaxa)
    tris = ((entry < gate[None]).to(torch.float64)
            * _prims_per_cluster(ctab, int(ct))[:, None]).sum(0)
    tris = torch.where(blocked, torch.clamp(tris, min=1.0), tris)
    n, c = o.shape[0], cb.shape[0]
    ops = n * c * SLAB_OPS + float(tris.sum()) * TRI_OPS
    return _bound(_nbytes(cb, ctab, cbd, o, d, tmin, tmaxc, tmaxa,
                          t_b, t_o, blocked), ops)


def check_walks(kg, n_check, rng, walks, occlusion_forms,
                random_tie_frac=TIE_FRAC):
    """Each closest-hit walk in `walks` (closest and any hit) and K3 in
    each of `occlusion_forms` against its plain version, on random and
    camera rays; returns max |t| error per kernel. The "planted" dual
    form runs on a seeded random 0/1 volume-boundary table, the "dual"
    form on the scene's own. Exact-t ties may take up random_tie_frac of
    the random rays' lanes, TIE_FRAC of the camera rays'."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    dev = ds["cluster_table"].device
    cb, ct_, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    planted = torch.tensor(rng.integers(0, 2, cbd.shape).astype(np.float32),
                           device=dev)
    ctris = int(kg["cluster_tris"])
    side = int(round(n_check ** 0.5))
    errs = {k: 0.0 for k in walks}
    if occlusion_forms:
        errs["occlusion_walk"] = 0.0
    for label, (o, d), tmin0 in (
            ("random", random_rays(n_check, rng, dev), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tmin = torch.full((n,), tmin0, device=dev)
        tmax = torch.full((n,), 1e30, device=dev)
        vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
        for any_hit in (False, True):
            ref = ci.intersect_clusters(cb, ct_, ctris, o, d, tmin, tmax,
                                        vis, shadow_any_hit=any_hit)
            for name in walks:
                got = wrapper(name)(cb, ct_, ctris, o, d, tmin, tmax, vis,
                                    shadow_any_hit=any_hit)
                sync()
                mode = "any-hit" if any_hit else "closest"
                errs[name] = max(errs[name], compare_walk(
                    f"{name} {mode} {label}", ref, got, any_hit,
                    random_tie_frac if label == "random" else TIE_FRAC))
        tmax_any = torch.tensor(
            np.where(rng.uniform(size=n) < 0.5, rng.uniform(10, 800, n),
                     1e30).astype(np.float32), device=dev)
        for form in occlusion_forms:
            tmaxc = tmin if form == "surface" else torch.tensor(
                rng.uniform(10, 1000, n).astype(np.float32), device=dev)
            bnd = planted if form == "planted" else cbd
            args = (cb, ct_, bnd, ctris, o, d, tmin, tmaxc, tmax_any, 1, 128)
            ref = ci.occlusion_clusters(*args)
            got = wrapper("occlusion_walk")(*args)
            sync()
            errs["occlusion_walk"] = max(errs["occlusion_walk"],
                                         compare_occlusion(
                f"occlusion_walk {form} {label}", ref, got,
                need_boundary=form != "surface"))
    return errs


@contextlib.contextmanager
def record_calls(names, nth):
    """While active, each named wrapper copies the arguments of its nth
    call into the yielded {name: store} and then runs as before (so it
    still launches and counts every call)."""
    stores = {}
    origs = {}
    for name in names:
        mod, fn_name = module(name), WRAPPERS[name][1]
        orig = getattr(mod, fn_name)
        origs[name] = (mod, fn_name, orig)
        store = stores[name] = {}

        def recording(*args, _orig=orig, _store=store, _calls=[0], **kw):
            _calls[0] += 1
            if _calls[0] == nth:
                _store["args"] = tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)
                _store["kw"] = {k: v.clone() if torch.is_tensor(v) else v
                                for k, v in kw.items()}
            return _orig(*args, **kw)

        setattr(mod, fn_name, recording)
    try:
        yield stores
    finally:
        for mod, fn_name, orig in origs.values():
            setattr(mod, fn_name, orig)


def shadow_rays(kg, o, d, rng):
    """NEE-like shadow rays: from the camera rays' first hits toward
    uniform points on the first light triangle."""
    ds = kg["dscene"]
    dev = o.device
    n = o.shape[0]
    vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
    hit = wrapper("cluster_walk")(
        ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
        o, d, torch.zeros(n, device=dev), torch.full((n,), 1e30, device=dev),
        vis)
    P = o + hit["t"][:, None] * d
    lr = ds["le_prim_rows"][0, :9].reshape(3, 3)
    uv = torch.tensor(rng.uniform(size=(n, 2)).astype(np.float32),
                      device=dev)
    su = uv[:, 0].sqrt()
    Pl = lr[0] + (lr[1] - lr[0]) * (1 - su)[:, None] \
        + (lr[2] - lr[0]) * (uv[:, 1] * su)[:, None]
    to_l = Pl - P
    dist = to_l.norm(dim=-1).clamp(min=1e-8)
    sd = (to_l / dist[:, None]).contiguous()
    so = (P + sd * 1e-2).contiguous()
    stmin = torch.full((n,), 1e-5, device=dev)
    stmax = torch.where(hit["prim"] >= 0, dist * (1 - 1e-3) - 1e-2, stmin)
    return so, sd, stmin, stmax.contiguous()


def timed_cases(cases, n, card, reps=(20, 3)):
    """Each case (kernel call, plain call, kernel name, compare, bound):
    held against its plain version, then both timed (median ms). Returns
    ({case: {"ms", "plain_ms", "bound_ms", "bound_by", "lanes"}},
    {kernel: max |t| error})."""
    times, errs = {}, {}
    for name, (kern, plain, which, compare, bound) in cases.items():
        got, ref = kern(), plain()
        sync()
        errs[which] = max(errs.get(which, 0.0),
                          compare(f"{name} @ {n}", ref, got))
        bound_ms, bound_by = bound(ref)
        ms, plain_ms = median_ms(kern, reps[0]), median_ms(plain, reps[1])
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "lanes": n}
        log(f"[time] {name} @ {n} lanes: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) "
            f"({card})")
    return times, errs


def _plain(name):
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    return (ci.occlusion_clusters if name == "occlusion_walk"
            else ci.intersect_clusters)


def _positional(name, rec):
    """A recorded call's arguments as the plain version's positional
    arguments, in its order (the integrator passes some by keyword)."""
    params = inspect.signature(_plain(name)).parameters
    # flags the plain version does not take must be off in the recorded call
    assert not any(v for k, v in rec["kw"].items() if k not in params)
    kw = {k: v for k, v in rec["kw"].items() if k in params}
    bound = inspect.signature(_plain(name)).bind(*rec["args"], **kw)
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def _recorded_case(name, rec, compare):
    """A timed case on a recorded call of wrapper `name`."""
    args = _positional(name, rec)
    if name == "occlusion_walk":
        return (lambda: wrapper(name)(*args), lambda: _plain(name)(*args),
                name, compare, lambda out: occlusion_bound(args, out))
    kw = {"shadow_any_hit": args[8]}
    return (lambda: wrapper(name)(*args[:8], **kw),
            lambda: _plain(name)(*args),
            name, compare, lambda out: walk_bound(args, kw, out))


def _lane_visibility(name, rec):
    rvis = _positional(name, rec)[7]
    kinds = sorted(int(x) for x in torch.unique(rvis).cpu())
    shares = [round(float((rvis == k).float().mean()), 4) for k in kinds]
    return kinds, shares


def glossy_main_path_checks(kg, side, rng, card, rec):
    """At side x side lanes: K2 closest on the render's recorded input and
    on camera rays, K2 any-hit on NEE-like shadow rays, K3 on the render's
    recorded input and on the shadow rays."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    cb, ct_, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    ctris = int(kg["cluster_tris"])
    o, d = camera_rays(kg, side, side, cb.device)
    n = o.shape[0]
    zeros = torch.zeros(n, device=cb.device)
    big = torch.full((n,), 1e30, device=cb.device)
    vis = torch.full((n,), 1, dtype=torch.int32, device=cb.device)
    so, sd, stmin, stmax = shadow_rays(kg, o, d, rng)
    svis = torch.full((n,), 128, dtype=torch.int32, device=cb.device)
    for r in rec.values():
        assert r["args"][4].shape[0] == n, "recorded call is not full width"
    kinds, shares = _lane_visibility("cluster_walk", rec["cluster_walk"])
    log(f"[main-path] recorded K2 input: visibility values {kinds}, lane "
        f"shares {shares}")
    assert len(kinds) > 1, "the recorded K2 call holds no bounce rays"
    k2, k3 = wrapper("cluster_walk"), wrapper("occlusion_walk")
    cam = (cb, ct_, ctris, o, d, zeros, big, vis)
    shadow = (cb, ct_, ctris, so, sd, stmin, stmax, svis)
    occ = (cb, ct_, cbd, ctris, so, sd, stmin, stmin, stmax, 1, 128)
    cases = {
        "K2 closest render": _recorded_case("cluster_walk",
                                            rec["cluster_walk"],
                                            compare_hits),
        "K2 closest camera": (
            lambda: k2(*cam), lambda: ci.intersect_clusters(*cam),
            "cluster_walk", compare_hits,
            lambda out: walk_bound(cam, {}, out)),
        "K2 any-hit shadow": (
            lambda: k2(*shadow, shadow_any_hit=True),
            lambda: ci.intersect_clusters(*shadow, shadow_any_hit=True),
            "cluster_walk", compare_any_hit,
            lambda out: walk_bound(shadow, {"shadow_any_hit": True}, out)),
        "K3 surface render": _recorded_case("occlusion_walk",
                                            rec["occlusion_walk"],
                                            compare_occlusion),
        "K3 surface shadow": (
            lambda: k3(*occ), lambda: ci.occlusion_clusters(*occ),
            "occlusion_walk", compare_occlusion,
            lambda out: occlusion_bound(occ, out)),
    }
    return timed_cases(cases, n, card)


def volume_main_path_checks(kg, side, card, rec):
    """At side x side lanes (the render's own width): K4 closest on the
    render's recorded input and on camera rays, K3's dual form on the
    render's recorded input (the real boundary table)."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    cb, ct_ = ds["cluster_bounds"], ds["cluster_table"]
    ctris = int(kg["cluster_tris"])
    o, d = camera_rays(kg, side, side, cb.device)
    n = o.shape[0]
    cam = (cb, ct_, ctris, o, d, torch.zeros(n, device=cb.device),
           torch.full((n,), 1e30, device=cb.device),
           torch.full((n,), 1, dtype=torch.int32, device=cb.device))
    for r in rec.values():
        assert r["args"][4].shape[0] == n, "recorded call is not full width"
    kinds, shares = _lane_visibility("tile_walk", rec["tile_walk"])
    log(f"[main-path] recorded K4 input: visibility values {kinds}, lane "
        f"shares {shares}")
    assert len(kinds) > 1, "the recorded K4 call holds no bounce rays"
    ra = _positional("occlusion_walk", rec["occlusion_walk"])
    log(f"[main-path] recorded K3 input: closest window on "
        f"{float((ra[7] > 1e-5).float().mean()):.4f}, any-hit window on "
        f"{float((ra[8] > 1e-5).float().mean()):.4f} of the lanes")
    k4 = wrapper("tile_walk")
    cases = {
        "K4 closest render": _recorded_case("tile_walk", rec["tile_walk"],
                                            compare_hits),
        "K4 closest camera": (
            lambda: k4(*cam), lambda: ci.intersect_clusters(*cam),
            "tile_walk", compare_hits,
            lambda out: walk_bound(cam, {}, out)),
        "K3 dual render": _recorded_case(
            "occlusion_walk", rec["occlusion_walk"],
            lambda *a: compare_occlusion(*a, need_boundary=True)),
    }
    return timed_cases(cases, n, card)


def accuracy(dev, twin_key, scene, flags, rmse_gate, frac_gate, spp=128,
             twin=None, twin_f32=None):
    """The scene's 64x64 x spp render, clamp off, vs the float64 twin."""
    from raytracingproject_tpu_torch.session.session import render
    if twin is None:
        twin = np.load(TWIN)[twin_key]
        twin_f32 = np.load(TWIN_F32)[twin_key]
    scene.integrator.set("sample_clamp_indirect", 0.0)
    scene.device_update()
    kg = scene.make_kernel_globals(dev)
    kg.update(flags)
    t0 = time.perf_counter()
    img = render(scene, spp, chunk=16, device=dev, kg=kg)
    dt = time.perf_counter() - t0
    assert np.isfinite(img).all() and img.shape == twin.shape
    diff = img.astype(np.float64) - twin
    rmse = float(np.sqrt(np.mean(diff * diff)))
    frac = float((np.abs(diff).sum(-1) > 1e-3).mean())
    d32 = img.astype(np.float64) - twin_f32
    size = img.shape[0]
    log(f"[accuracy] {twin_key} {size}x{size}x{spp} in {dt:.2f} s: rmse vs "
        f"twin_f64 {rmse:.3e} (gate {rmse_gate}), pixels off >1e-3 "
        f"{frac:.5f} (gate {frac_gate}), rmse vs twin_f32 "
        f"{np.sqrt(np.mean(d32 * d32)):.3e}, mean {img.mean():.6f} vs twin "
        f"{twin.mean():.6f}")
    assert rmse <= rmse_gate and frac <= frac_gate, \
        f"{twin_key}: accuracy gate failed"
    return float(twin.mean())


def full_width(card, spec, width, spp, ref_mean, mean_gate, path_kernels,
               device="cuda", chunk=16):
    """The full-width render through the CLI code path. Every kernel's
    launch count is set to 0 just before it and read just after; each
    kernel of `path_kernels` must have launched. Returns the counts and
    the recorded inputs of each path kernel's RECORD_CALL-th call."""
    from raytracingproject_tpu_torch.app import cli
    args = cli.build_parser().parse_args(
        [spec, "--samples", str(spp), "--width", str(width), "--height",
         str(width), "--chunk", str(chunk), "--lanes-per-pixel", "1",
         "--device", device])
    with record_calls(path_kernels, RECORD_CALL) as rec:
        reset_launches()
        img, st = cli.run(args)
        launches = {name: launches_of(name) for name in WRAPPERS}
    mean = float(img.astype(np.float64).mean())
    mean_rel = abs(mean / ref_mean - 1.0)
    log(f"[render] {spec} {width}x{width}x{spp} chunk {chunk}: "
        f"{st['render_s']:.3f} s, {st['msamples_per_s']:.4f} Msamples/s on "
        f"{card}; host compile {st['compile_s']:.3f} s; mean {mean:.8f} "
        f"(JAX package {ref_mean:.8f}, rel {mean_rel:.2e}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    assert img.shape == (width, width, 3) and np.isfinite(img).all()
    assert mean_rel <= mean_gate, f"{spec}: full-width mean off the JAX " \
        "package's"
    for name in path_kernels:
        assert launches[name] > 0, f"{spec}: the render did not launch {name}"
        assert "args" in rec[name], f"{spec}: no {name} call was recorded"
    return launches, rec, st


def scene_box(kg):
    """The union of the cluster boxes: the scene's bounds."""
    cb = kg["dscene"]["cluster_bounds"].cpu().numpy()
    return cb[:, :3].min(0), cb[:, 3:].max(0)


def k5_call(kg, o, d, tmin, tmax, vis, any_hit, kernel="cluster2_walk"):
    """K5, K6 (kernel="onehot2_walk") or, kernel=None, their plain version
    on the scene's tables."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    tabs = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]))
    if kernel:
        return wrapper(kernel)(
            ds["sc_bounds"], *tabs, int(kg["sc_gmax"]), o, d, tmin, tmax,
            vis, shadow_any_hit=any_hit, has_instances=True)
    return ci.intersect_clusters(*tabs, o, d, tmin, tmax, vis,
                                 shadow_any_hit=any_hit, has_instances=True)


def cluster2_bound(kg, args, any_hit, out):
    """(bound ms, bound_by) of one K5 or K6 call (the work a lane must do
    is the same in both). Bytes: tables, rays and
    results once. Operations: every lane tests every supercluster box; a
    closest-hit lane tests the cluster boxes of each group it enters
    before its final t, and in each cluster it enters before its final t
    the instance transform and the triangles (a miss: every group and
    cluster it enters); an any-hit lane that hits needs one transform and
    one triangle."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    scb, cb, ctab = ds["sc_bounds"], ds["cluster_bounds"], \
        ds["cluster_table"]
    o, d, tmin, tmax, vis = args
    sc_entry = ci.entry_table(scb[:, :6], o, d, tmin, tmax)
    c_entry = ci.entry_table(cb, o, d, tmin, tmax)
    sc_in, c_in = sc_entry < ci.INF, c_entry < ci.INF
    if not any_hit:
        sc_in = sc_in & (sc_entry < out["t"][None])
        c_in = c_in & (c_entry < out["t"][None])
    gboxes = (sc_in.to(torch.float64)
              * scb[:, 7].to(torch.float64)[:, None]).sum(0)
    per_cluster = _prims_per_cluster(ctab, int(kg["cluster_tris"])) \
        * TRI_OPS + XFORM_OPS
    row_ops = (c_in.to(torch.float64) * per_cluster[:, None]).sum(0)
    if any_hit:
        row_ops = torch.where(out["prim"] >= 0, float(TRI_OPS + XFORM_OPS),
                              row_ops)
    n = o.shape[0]
    ops = n * scb.shape[0] * SLAB_OPS + float(gboxes.sum()) * SLAB_OPS \
        + float(row_ops.sum())
    return _bound(_nbytes(scb, cb, ctab, *args, *out.values()), ops)


def check_cluster2(kg, n_check, rng, kernel="cluster2_walk"):
    """K5 (or K6) against its plain version, closest and any hit, on
    random rays from inside the scene's bounds and on camera rays: hit
    masks equal, max |dt| 0 off exact ties. Returns max |t| error."""
    dev = kg["dscene"]["cluster_table"].device
    side = int(round(n_check ** 0.5))
    lo, hi = scene_box(kg)
    err = 0.0
    for label, (o, d), tmin0 in (
            ("random", random_rays(n_check, rng, dev, lo, hi), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tmin = torch.full((n,), tmin0, device=dev)
        tmax = torch.full((n,), 1e30, device=dev)
        vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
        for any_hit in (False, True):
            ref = k5_call(kg, o, d, tmin, tmax, vis, any_hit, kernel=None)
            got = k5_call(kg, o, d, tmin, tmax, vis, any_hit, kernel)
            sync()
            mode = "any-hit" if any_hit else "closest"
            e = compare_walk(f"{kernel} {mode} {label}", ref, got, any_hit)
            assert e == 0.0, f"{kernel} {mode} {label}: |dt| {e} off the ties"
            err = max(err, e)
    return {kernel: err}


def sun_shadow_rays(kg, o, d, rng):
    """NEE shadow rays toward the distant lamp from the camera rays' first
    hits (directions from the port's own light sampler); lanes that miss
    get the empty window [1e-5, 1e-5], as the integrator gives them."""
    from raytracingproject_tpu_torch.ops import light as light_ops
    dev = o.device
    n = o.shape[0]
    vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
    hit = k5_call(kg, o, d, torch.zeros(n, device=dev),
                  torch.full((n,), 1e30, device=dev), vis, False, None)
    P = o + hit["t"][:, None] * d
    u = [torch.tensor(rng.uniform(size=n).astype(np.float32), device=dev)
         for _ in range(3)]
    ls = light_ops.sample_light(kg["dscene"], P, *u,
                                static_kinds=kg["light_kinds"])
    sd = ls["D"].contiguous()
    so = (P + sd * 1e-3).contiguous()
    stmin = torch.full((n,), 1e-5, device=dev)
    stmax = torch.where(hit["prim"] >= 0, ls["dist"], stmin).contiguous()
    return so, sd, stmin, stmax


def big_main_path_checks(kg, side, rng, card, rec, kernel="cluster2_walk"):
    """At side x side lanes (the render's own width): K5 (or K6) closest
    on the render's recorded input and any-hit on sun shadow rays; with
    K6, K5 is timed on the same recorded input beside it."""
    tag = {"cluster2_walk": "K5", "onehot2_walk": "K6"}[kernel]
    ra = inspect.signature(wrapper(kernel)).bind(
        *rec["args"], **rec["kw"])
    ra.apply_defaults()
    a = ra.arguments
    n = a["o"].shape[0]
    assert n == side * side, "recorded call is not full width"
    assert not a["shadow_any_hit"], "the recorded call is not a closest hit"
    rvis = a["visibility"]
    kinds = sorted(int(x) for x in torch.unique(rvis).cpu())
    log(f"[main-path] recorded {tag} input: visibility values {kinds}, lane "
        f"shares {[round(float((rvis == k).float().mean()), 4) for k in kinds]}")
    assert len(kinds) > 1, "the recorded call holds no bounce rays"
    rargs = (a["o"], a["d"], a["tmin"], a["tmax"], a["visibility"])
    o, d = camera_rays(kg, side, side, a["o"].device)
    so, sd, stmin, stmax = sun_shadow_rays(kg, o, d, rng)
    sargs = (so, sd, stmin, stmax,
             torch.full((n,), 128, dtype=torch.int32, device=o.device))

    def case(args, any_hit, compare, which=kernel):
        return (lambda: k5_call(kg, *args, any_hit, which),
                lambda: k5_call(kg, *args, any_hit, None),
                which, compare,
                lambda out: cluster2_bound(kg, args, any_hit, out))

    cases = {f"{tag} closest render": case(rargs, False, compare_hits),
             f"{tag} any-hit shadow": case(sargs, True, compare_any_hit)}
    if kernel == "onehot2_walk":
        cases["K5 closest on K6's render input"] = case(
            rargs, False, compare_hits, "cluster2_walk")
    log(f"[main-path] sun shadow rays: {float((stmax > 1e-5).float().mean()):.4f}"
        " of the lanes have a segment")
    return timed_cases(cases, n, card)


def dense_plain(name):
    from raytracingproject_tpu_torch.ops import intersect as isect
    return getattr(isect, DENSE_PLAIN[name])


def dense_tables(kg, rng):
    """(tri_verts, prim_object, object_visibility, boundary mask) of a
    use_brute scene; a scene without volume gets a seeded boundary mask
    planted, so that both minima of the dual form are exercised."""
    ds = kg["dscene"]
    bnd = ds["prim_is_boundary"]
    if not bool(bnd.any()):
        bnd = torch.tensor(rng.uniform(size=bnd.shape[0]) < 0.3,
                           device=bnd.device)
    return (ds["tri_verts_world"], ds["prim_object_packed"],
            ds["object_visibility"], bnd)


def mt_packets(tri_verts, prim_object):
    """The (nb, 8, 3) v0/e1/e2 packets of the Moeller-Trumbore mode."""
    from raytracingproject_tpu_torch.ops import intersect as isect
    _nb, v0, e1, e2, _po, _pv = isect.pack_tri_blocks(tri_verts, prim_object,
                                                      None)
    return tuple(x.contiguous() for x in (v0, e1, e2))


def compare_equal(name, ref, got):
    """K1 follows its plain version's winner rule literally: every output
    equal to the bit. Returns the max |t| error (0)."""
    for k in ref:
        assert torch.equal(ref[k], got[k]), f"{name}: {k} differs"
    log(f"[kernels] {name}: {ref['t'].shape[0]} lanes, hit "
        f"{float((ref['prim'] >= 0).float().mean()):.4f}, prim, t, u, v "
        "equal to the bit")
    return 0.0


def compare_blocked(name, ref, got):
    assert torch.equal(ref, got), f"{name}: blocked masks differ"
    log(f"[kernels] {name}: {ref.shape[0]} lanes, masks equal, blocked "
        f"{float(ref.float().mean()):.4f}")
    return 0.0


def compare_dual(name, ref, got):
    e = compare_occlusion(name, ref, got, need_boundary=True)
    assert e == 0.0, f"{name}: |dt| {e}"
    return e


DENSE_COMPARE = {"dense_closest": compare_equal, "dense_any": compare_blocked,
                 "dense_dual": compare_dual, "dense_mt": compare_equal}


def dense_bound(name, args, kw, out):
    """(bound ms, bound_by) of one K1 call. Bytes: triangles, rays and
    results once. Operations: a closest-hit, dual or Moeller-Trumbore lane
    with a non-empty window tests every triangle; an any-hit lane that is
    blocked needs one test, an unblocked one with a window every
    triangle."""
    sig = inspect.signature(dense_plain(name)).bind(*args, **kw)
    a = sig.arguments
    if name == "dense_mt":
        p = a["tri_v0"].shape[0] * a["tri_v0"].shape[1]
        tests = float((a["tmax"] > a["tmin"]).sum()) * p
        per_test = MT_OPS
    else:
        p = a["tri_verts"].shape[0]
        per_test = TRI_OPS
        if name == "dense_dual":
            window = torch.maximum(a["tmax_closest"], a["tmax_any"]) \
                > a["tmin"]
            tests = float(window.sum()) * p
        else:
            window = a["tmax"] > a["tmin"]
            per_lane = torch.where(window, float(p), 0.0)
            if name == "dense_any":
                per_lane = torch.where(out, 1.0, per_lane)
            tests = float(per_lane.sum())
    outs = out.values() if isinstance(out, dict) else (
        out if isinstance(out, tuple) else (out,))
    return _bound(_nbytes(*a.values(), *outs), tests * per_test)


def check_dense(kg, n_check, rng, label):
    """K1's four modes against their plain versions on the scene's dense
    arrays: random rays with mixed per-lane visibility and a tenth of the
    windows empty, and camera rays. Returns max |t| error per mode."""
    tv, po, ov, bnd = dense_tables(kg, rng)
    dev = tv.device
    side = int(round(n_check ** 0.5))
    packets = mt_packets(tv, po)
    errs = {k: 0.0 for k in DENSE_MODE}
    kinds = np.array([1, 8, 16, 4, 128], np.int32)
    for rays, (o, d), tmin0 in (
            ("random", random_rays(n_check, rng, dev), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tmin = torch.full((n,), tmin0, device=dev)
        empty = rng.uniform(size=n) < (0.1 if rays == "random" else 0.0)
        tmax = torch.tensor(np.where(empty, tmin0, 1e30).astype(np.float32),
                            device=dev)
        tmax_any = torch.tensor(
            np.where(rng.uniform(size=n) < 0.5, rng.uniform(10, 800, n),
                     1e30).astype(np.float32), device=dev)
        tmax_c = torch.tensor(rng.uniform(10, 1000, n).astype(np.float32),
                              device=dev)
        vis = torch.tensor(kinds[rng.integers(0, 5, n)] if rays == "random"
                           else np.ones(n, np.int32), device=dev)
        svis = torch.full((n,), 128, dtype=torch.int32, device=dev)
        calls = {
            "dense_closest": (tv, po, o, d, tmin, tmax, vis, ov),
            "dense_any": (tv, po, o, d, tmin, tmax_any, svis, ov),
            "dense_dual": (tv, po, bnd, o, d, tmin, tmax_c, tmax_any, vis,
                           svis, ov),
            "dense_mt": (*packets, o, d, tmin, tmax),
        }
        for name, args in calls.items():
            ref, got = dense_plain(name)(*args), wrapper(name)(*args)
            sync()
            errs[name] = max(errs[name], DENSE_COMPARE[name](
                f"{name} {label} {rays}", ref, got))
    return errs


def dense_main_path_checks(kg, label, n, card, rec):
    """At the render's own width: each recorded K1 call (the third of its
    mode in the full-width render) held against its plain version and
    timed, and the Moeller-Trumbore mode on the recorded closest-hit
    rays."""
    cases = {}
    for name, r in rec.items():
        args, kw = r["args"], r["kw"]
        lanes = inspect.signature(dense_plain(name)).bind(
            *args, **kw).arguments["o"].shape[0]
        assert lanes == n, "recorded call is not full width"
        cases[f"K1 {DENSE_MODE[name]} render ({label})"] = (
            lambda name=name, args=args, kw=kw: wrapper(name)(*args, **kw),
            lambda name=name, args=args, kw=kw: dense_plain(name)(*args,
                                                                  **kw),
            name, DENSE_COMPARE[name],
            lambda out, name=name, args=args, kw=kw: dense_bound(
                name, args, kw, out))
    a = inspect.signature(dense_plain("dense_closest")).bind(
        *rec["dense_closest"]["args"],
        **rec["dense_closest"]["kw"]).arguments
    rvis = a["visibility"]
    kinds = sorted(int(x) for x in torch.unique(rvis).cpu())
    log(f"[main-path] recorded K1 closest input ({label}): visibility values "
        f"{kinds}, lane shares "
        f"{[round(float((rvis == k).float().mean()), 4) for k in kinds]}")
    assert len(kinds) > 1, "the recorded K1 call holds no bounce rays"
    mt = (*mt_packets(a["tri_verts"], a["prim_object"]), a["o"], a["d"],
          a["tmin"], a["tmax"])
    cases[f"K1 mt render rays ({label})"] = (
        lambda: wrapper("dense_mt")(*mt), lambda: dense_plain("dense_mt")(*mt),
        "dense_mt", compare_equal,
        lambda out: dense_bound("dense_mt", mt, {}, out))
    return timed_cases(cases, n, card)


def compare_dual_walk(name, ref, got):
    """K7: blocked masks equal everywhere; the closest hit as compare_hits
    holds a walk's. Returns the max |t| error off the tie lanes."""
    (rhit, rblk), (ghit, gblk) = ref, got
    assert torch.equal(rblk, gblk), f"{name}: blocked masks differ"
    err = compare_hits(name, rhit, ghit)
    log(f"[kernels] {name}: blocked equal "
        f"({float(gblk.float().mean()):.4f} blocked)")
    return err


def dual_bound(args, out):
    """(bound ms, bound_by) of one K7 call. Bytes: tables, both rays and
    results once. Operations: each ray with a non-empty window tests every
    cluster box once; the closest ray tests the triangles of each cluster
    it enters before its final t, the any-hit ray one triangle where it is
    blocked and else those of every cluster it enters."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    (cb, ctab, ct, o_c, d_c, tmin_c, tmax_c, vis_c, o_a, d_a, tmin_a, tmax_a,
     vis_a) = args
    hit, blocked = out
    per = _prims_per_cluster(ctab, int(ct))[:, None]
    live_c, live_a = tmax_c > tmin_c, tmax_a > tmin_a
    entry = ci.entry_table(cb, o_c, d_c, tmin_c, tmax_c)
    in_c = (entry < ci.INF) & (entry < hit["t"][None]) & live_c[None]
    tris = (in_c.to(torch.float64) * per).sum(0)
    entry = ci.entry_table(cb, o_a, d_a, tmin_a, tmax_a)
    in_a = (entry < ci.INF) & live_a[None]
    tris = tris + torch.where(blocked, 1.0,
                              (in_a.to(torch.float64) * per).sum(0))
    boxes = float(live_c.sum() + live_a.sum()) * cb.shape[0]
    ops = boxes * SLAB_OPS + float(tris.sum()) * TRI_OPS
    return _bound(_nbytes(*args, *hit.values(), blocked), ops)


def check_dual(kg, n_check, rng):
    """K7 against its plain version on the glossy tables: random closest
    rays with mixed per-lane visibility paired with any-hit rays from
    nearby origins toward the lamp, each ray of those pairs switched off in
    turn by an empty window, and camera rays paired with NEE-like shadow
    rays. Returns the max |t| error."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    dev = ds["cluster_table"].device
    tabs = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]))
    side = int(round(n_check ** 0.5))
    k7 = wrapper("dual_walk")
    err = 0.0

    def held(label, *rays):
        args = (*tabs, *rays, torch.full((rays[0].shape[0],), 128,
                                         dtype=torch.int32, device=dev))
        ref, got = ci.intersect_clusters_dual(*args), k7(*args)
        sync()
        return compare_dual_walk(f"dual_walk {label}", ref, got), got

    # random pairs
    o, d = random_rays(n_check, rng, dev)
    n = o.shape[0]
    o_a = (o + 0.05).contiguous()
    to_l = torch.tensor([278.0, 548.0, 279.0], device=dev) - o_a
    dist = to_l.norm(dim=-1)
    d_a = (to_l / dist[:, None]).contiguous()
    tmin = torch.full((n,), 1e-4, device=dev)
    big = torch.full((n,), 1e30, device=dev)
    empty = torch.full((n,), -1.0, device=dev)
    tmax_a = (dist * 0.999).contiguous()
    vis_c = torch.tensor(
        np.array([1, 8, 16], np.int32)[rng.integers(0, 3, n)], device=dev)
    e, (hit, blk) = held("random", o, d, tmin, big, vis_c, o_a, d_a, tmin,
                         tmax_a)
    err = max(err, e)
    assert 0.05 < float(blk.float().mean()) < 0.95
    assert float((hit["prim"] >= 0).float().mean()) > 0.05
    e, (hit, blk) = held("random, any-hit ray off", o, d, tmin, big, vis_c,
                         o_a, d_a, tmin, empty)
    err = max(err, e)
    assert not bool(blk.any()) and bool((hit["prim"] >= 0).any())
    e, (hit, blk) = held("random, closest ray off", o, d, tmin, empty, vis_c,
                         o_a, d_a, tmin, tmax_a)
    err = max(err, e)
    assert bool((hit["prim"] == -1).all()) and torch.equal(hit["t"], empty)
    assert bool(blk.any())

    # camera rays with NEE-like shadow rays
    o, d = camera_rays(kg, side, side, dev)
    n = o.shape[0]
    so, sd, stmin, stmax = shadow_rays(kg, o, d, rng)
    e, (hit, blk) = held(
        "camera", o, d, torch.zeros(n, device=dev),
        torch.full((n,), 1e30, device=dev),
        torch.full((n,), 1, dtype=torch.int32, device=dev), so, sd, stmin,
        stmax)
    assert bool(blk.any()) and not bool(blk.all())
    return {"dual_walk": max(err, e)}


def fused_main_path_checks(kg, side, card, rec):
    """At side x side lanes: K7 on the fused render's recorded input, and
    on the same rays K2 (the closest half) and K3's surface form (the
    any-hit half), the two calls the union walk replaces."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ra = inspect.signature(wrapper("dual_walk")).bind(*rec["args"],
                                                      **rec["kw"])
    ra.apply_defaults()
    a = ra.arguments
    assert not a["has_instances"] and not a["has_motion"]
    args = tuple(a.values())[:13]
    (cb, ctab, ct, o_c, d_c, tmin_c, tmax_c, vis_c, o_a, d_a, tmin_a, tmax_a,
     _vis_a) = args
    n = o_c.shape[0]
    assert n == side * side, "recorded call is not full width"
    kinds = sorted(int(x) for x in torch.unique(vis_c).cpu())
    log(f"[main-path] recorded K7 input: visibility values {kinds}, lane "
        f"shares {[round(float((vis_c == k).float().mean()), 4) for k in kinds]}"
        f"; closest window on {float((tmax_c > tmin_c).float().mean()):.4f}, "
        f"any-hit window on {float((tmax_a > tmin_a).float().mean()):.4f} of "
        "the lanes")
    assert len(kinds) > 1, "the recorded K7 call holds no bounce rays"
    assert bool((tmax_a > tmin_a).any()), "the recorded K7 call tests no shadow"
    k7, k2, k3 = (wrapper(x) for x in ("dual_walk", "cluster_walk",
                                       "occlusion_walk"))
    closest = (cb, ctab, ct, o_c, d_c, tmin_c, tmax_c, vis_c)
    # the unfused step gives a lane without a shadow test the empty window
    # [tmin, tmin]
    occ = (cb, ctab, kg["dscene"]["cluster_boundary"], ct, o_a, d_a, tmin_a,
           tmin_a, torch.maximum(tmax_a, tmin_a), 1, 128)
    cases = {
        "K7 dual render": (
            lambda: k7(*args), lambda: ci.intersect_clusters_dual(*args),
            "dual_walk", compare_dual_walk,
            lambda out: dual_bound(args, out)),
        "K2 closest on K7's render input": (
            lambda: k2(*closest), lambda: ci.intersect_clusters(*closest),
            "cluster_walk", compare_hits,
            lambda out: walk_bound(closest, {}, out)),
        "K3 surface on K7's render input": (
            lambda: k3(*occ), lambda: ci.occlusion_clusters(*occ),
            "occlusion_walk", compare_occlusion,
            lambda out: occlusion_bound(occ, out)),
    }
    return timed_cases(cases, n, card)


def adaptive_checks(dev, card):
    """render_adaptive_device on the glossy scene, unfused and fused: with
    threshold 0 every pixel takes its whole budget and the image is the
    fixed render's; with ADAPTIVE_THRESHOLD the loop converges on fewer
    samples and the image mean stays within 1%."""
    from raytracingproject_tpu_torch.app import examples
    from raytracingproject_tpu_torch.session.adaptive import \
        render_adaptive_device
    from raytracingproject_tpu_torch.session.session import render
    size, spp, chunk = ADAPTIVE_SIZE, ADAPTIVE_SPP, ADAPTIVE_CHUNK
    scene = examples.cornell_box(size, size, spp=spp, spheres="glossy")
    scene.device_update()
    fixed = float(render(scene, spp, chunk=16, device=dev,
                         kg=scene.make_kernel_globals(dev))
                  .astype(np.float64).mean())
    for fused in (False, True):
        kg = scene.make_kernel_globals(dev)
        if fused:
            kg.update(examples.GLOSSY_FUSED)
        for thr in (0.0, ADAPTIVE_THRESHOLD):
            reset_launches()
            t0 = time.perf_counter()
            L, _A, counts, st = render_adaptive_device(
                kg, size, size, spp, threshold=thr, chunk=chunk)
            sync()
            dt = time.perf_counter() - t0
            ran = {k: launches_of(k) for k in ("dual_walk", "cluster_walk",
                                               "occlusion_walk")}
            mean = float((L.astype(np.float64) / counts[:, None]).mean())
            rel = abs(mean / fixed - 1.0)
            log(f"[adaptive] glossy {size}x{size}, budget {spp}, chunk "
                f"{chunk}, threshold {thr}, {'fused' if fused else 'unfused'}"
                f": {dt:.3f} s, {st['samples_rendered'] / dt / 1e6:.4f} "
                f"Msamples/s on {card}; {st['dispatches']} rounds, "
                f"{st['samples_rendered']} of {st['samples_nominal']} "
                f"samples, counts {st['min_samples']}..{st['max_samples']}, "
                f"mean {mean:.8f} (fixed render {fixed:.8f}, rel {rel:.2e}); "
                f"launches {ran}")
            assert np.isfinite(L).all() and st["converged"] \
                and st["n_active"] == 0
            if fused:
                assert ran["dual_walk"] > 0 and ran["cluster_walk"] == 0 \
                    and ran["occlusion_walk"] == 0
            else:
                assert ran["dual_walk"] == 0 and ran["cluster_walk"] > 0 \
                    and ran["occlusion_walk"] > 0
            if thr == 0.0:
                assert (counts == spp).all() and rel <= 0.005
            else:
                assert st["samples_rendered"] < st["samples_nominal"]
                assert rel <= 0.01


def merge(errs, new):
    """Keep the largest error per kernel."""
    for k, v in new.items():
        errs[k] = max(errs.get(k, 0.0), v)


def main():
    # ---- 1. environment ----
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from raytracingproject_tpu_torch import kernels
    from raytracingproject_tpu_torch.app import examples
    from raytracingproject_tpu_torch.device import get_device
    dev = get_device("cuda")
    card = card_line()
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, tf32 cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # ---- 2. build ----
    t0 = time.perf_counter()
    kernels.load()
    log(f"[build] {len(kernels.sources())} sources, built "
        f"{kernels.build_info['built']} in parallel in "
        f"{kernels.build_info['seconds']:.2f} s (load "
        f"{time.perf_counter() - t0:.2f} s)")
    for line in kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    rng = np.random.default_rng(SEED)

    # ---- glossy_nee_mis: 3. kernel checks; 4. accuracy; 5. full width;
    # 6. main-path shapes ----
    scene = examples.cornell_box(512, 512, spp=64, spheres="glossy")
    scene.device_update()
    kg = scene.make_kernel_globals(dev)
    errs = check_walks(kg, N_CHECK, rng, ("cluster_walk", "tile_walk"),
                       ("surface", "planted"))
    accuracy(dev, "glossy_nee_mis",
             examples.cornell_box(64, 64, spp=128, spheres="glossy"), {},
             5.7e-5, 0.0007)
    g_launch, g_rec, g_st = full_width(
        card, "example:cornell:glossy", 512, 64, JAX_MEAN_512, 0.005,
        ("cluster_walk", "occlusion_walk"))
    g_times, e = glossy_main_path_checks(kg, 512, rng, card, g_rec)
    merge(errs, e)

    # ---- volume_sss: 7. kernel checks; 8. accuracy; 9. full width;
    # 10. main-path shapes ----
    vscene = examples.volume_sss_scene(256, 256, spp=32)
    vscene.device_update()
    vkg = vscene.make_kernel_globals(dev)
    vkg.update(examples.VOLUME_SSS_DISPATCH)
    e = check_walks(vkg, N_CHECK, rng, ("tile_walk",), ("dual",),
                    random_tie_frac=TIE_FRAC_COPLANAR)
    merge(errs, e)
    accuracy(dev, "volume_sss", examples.volume_sss_scene(64, 64, spp=128),
             examples.VOLUME_SSS_DISPATCH, 1.15e-4, 0.0015)
    v_launch, v_rec, v_st = full_width(
        card, "example:volume_sss", 256, 32, JAX_MEAN_VOL_256, 0.01,
        ("tile_walk", "occlusion_walk"))
    v_times, e = volume_main_path_checks(vkg, 256, card, v_rec)
    merge(errs, e)

    # ---- big_instanced: 11. kernel checks; 12. accuracy; 13. full width;
    # 14. main-path shapes ----
    bscene = examples.instanced_scene(256, 256, spp=16, grid=8)
    bscene.device_update()
    bkg = bscene.make_kernel_globals(dev)
    assert "sc_bounds" in bkg["dscene"] and bkg["has_instances"]
    merge(errs, check_cluster2(bkg, N_CHECK, rng))
    pair = np.load(TWIN_BIG)
    d32 = pair["f32_jax"] - pair["f64"]
    jax_rmse = float(np.sqrt(np.mean(d32 * d32)))
    jax_frac = float((np.abs(d32).sum(-1) > 1e-3).mean())
    log(f"[accuracy] big_instanced: the JAX package's f32 render vs the "
        f"twin: rmse {jax_rmse:.3e}, pixels off >1e-3 {jax_frac:.5f}")
    accuracy(dev, "big_instanced",
             examples.instanced_scene(64, 64, spp=128, grid=8), {},
             2.0 * jax_rmse, 2.0 * jax_frac, twin=pair["f64"],
             twin_f32=pair["f32_jax"])
    b_launch, b_rec, b_st = full_width(
        card, "example:big_instanced", 256, 16, JAX_MEAN_BIG_256, 0.005,
        ("cluster2_walk",), chunk=8)
    b_times, e = big_main_path_checks(bkg, 256, rng, card,
                                      b_rec["cluster2_walk"])
    merge(errs, e)

    # ---- cornell_diffuse: 15. kernel checks; 16. accuracy; 17. full
    # width; 18. main-path shapes ----
    cscene = examples.cornell_box(512, 512, spp=64)
    cscene.device_update()
    ckg = cscene.make_kernel_globals(dev)
    assert ckg["use_brute"] and "cluster_table" not in ckg["dscene"]
    merge(errs, check_dense(ckg, N_CHECK, rng, "cornell"))
    accuracy(dev, "cornell_diffuse", examples.cornell_box(64, 64, spp=128),
             {}, 5.7e-5, 0.0007)
    c_launch, c_rec, c_st = full_width(
        card, "example:cornell", 512, 64, JAX_MEAN_CORNELL_512, 0.005,
        ("dense_closest", "dense_any"), chunk=32)
    c_times, e = dense_main_path_checks(ckg, "cornell", 512 * 512, card, c_rec)
    merge(errs, e)

    # ---- volume_sss, dense dispatch: 19. kernel checks; 20. accuracy; 21.
    # full width; 22. main-path shapes ----
    dkg = vscene.make_kernel_globals(dev)
    assert dkg["use_brute"]
    merge(errs, check_dense(dkg, N_CHECK, rng, "volume_sss"))
    accuracy(dev, "volume_sss", examples.volume_sss_scene(64, 64, spp=128),
             {}, 1.15e-4, 0.0015)
    d_launch, d_rec, d_st = full_width(
        card, "example:volume_sss:dense", 256, 32, JAX_MEAN_VOL_256, 0.01,
        ("dense_closest", "dense_dual"))
    d_times, e = dense_main_path_checks(dkg, "volume_sss", 256 * 256, card,
                                        d_rec)
    merge(errs, e)

    # ---- big_instanced with pallas_onehot2: 23. kernel checks; 24. full
    # width; 25. main-path shapes ----
    merge(errs, check_cluster2(bkg, N_CHECK, rng, "onehot2_walk"))
    o_launch, o_rec, o_st = full_width(
        card, "example:big_instanced:onehot2", 256, 16, JAX_MEAN_BIG_256,
        0.005, ("onehot2_walk",), chunk=8)
    assert o_launch["cluster2_walk"] == 0
    o_times, e = big_main_path_checks(bkg, 256, rng, card,
                                      o_rec["onehot2_walk"], "onehot2_walk")
    merge(errs, e)

    # ---- glossy_nee_mis, fused-NEE mode: 26. kernel checks; 27. accuracy;
    # 28. full width; 29. main-path shapes ----
    merge(errs, check_dual(kg, N_CHECK, rng))
    before = launches_of("dual_walk")
    accuracy(dev, "glossy_nee_mis",
             examples.cornell_box(64, 64, spp=128, spheres="glossy"),
             examples.GLOSSY_FUSED, 5.7e-5, 0.0007)
    assert launches_of("dual_walk") > before, "the fused render ran unfused"
    f_launch, f_rec, f_st = full_width(
        card, "example:cornell:glossy:fused", 512, 64, JAX_MEAN_512, 0.005,
        ("dual_walk",))
    assert f_launch["cluster_walk"] == 0 and f_launch["occlusion_walk"] == 0
    f_times, e = fused_main_path_checks(kg, 512, card, f_rec["dual_walk"])
    merge(errs, e)

    # ---- 30. the adaptive loop ----
    adaptive_checks(dev, card)

    paths = {"glossy_nee_mis": (g_launch, g_st), "volume_sss": (v_launch, v_st),
             "big_instanced": (b_launch, b_st),
             "cornell_diffuse": (c_launch, c_st),
             "volume_sss_dense": (d_launch, d_st),
             "big_instanced_onehot2": (o_launch, o_st),
             "glossy_nee_mis_fused": (f_launch, f_st)}
    by_path = {name: {path: launch[name]
                      for path, (launch, _st) in paths.items()}
               for name in WRAPPERS}
    log("[render] Msamples/s: " + ", ".join(
        f"{path} {st['msamples_per_s']:.4f}"
        for path, (_l, st) in paths.items()) + f" ({card})")
    times = {**g_times, **v_times, **b_times, **c_times, **d_times,
             **o_times, **f_times}
    # kernel, source, the TPU kernel's pallas_call, its timed case, the
    # prefix of its other cases
    k1 = ("dense_sweep", "pallas_intersect.py:156")
    rows = (("dense_closest", *k1, "K1 closest render (volume_sss)",
             "K1 closest"),
            ("dense_any", *k1, "K1 any render (cornell)", "K1 any"),
            ("dense_dual", *k1, "K1 dual render (volume_sss)", "K1 dual"),
            ("cluster_walk", "cluster_walk", "pallas_onehot.py:1008",
             "K2 closest render", "K2"),
            ("occlusion_walk", "occlusion_walk", "pallas_cluster.py:811",
             "K3 dual render", "K3"),
            ("tile_walk", "tile_walk", "pallas_cluster.py:253",
             "K4 closest render", "K4"),
            ("cluster2_walk", "cluster2_walk", "pallas_cluster.py:565",
             "K5 closest render", "K5"),
            ("onehot2_walk", "onehot2_walk", "pallas_onehot.py:619",
             "K6 closest render", "K6"),
            ("dual_walk", "dual_walk", "pallas_onehot.py:929",
             "K7 dual render", "K7"))
    kern = []
    for name, source, tpu, case, prefix in rows:
        tm = times[case]
        assert sum(by_path[name].values()) > 0, f"{name} never launched"
        kern.append({
            "name": name, "route": "cuda",
            "source": f"raytracingproject_tpu_torch/csrc/{source}.cu",
            "replaces": f"raytracingproject_tpu/ops/{tpu}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": errs[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "timed_case": case, "lanes": tm["lanes"],
            "cases": {c: t for c, t in times.items()
                      if c.startswith(prefix)}})
    # K1's fourth mode computes the TPU kernel's own Moeller-Trumbore
    # contract, which no render of either package calls: its checks and
    # times ride on the closest mode's entry
    assert by_path["dense_mt"] == {path: 0 for path in paths}
    kern[0]["mt_mode"] = {
        "max_abs_err": errs["dense_mt"], "launches": 0,
        "cases": {c: t for c, t in times.items() if c.startswith("K1 mt")}}
    print(card_line())
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
