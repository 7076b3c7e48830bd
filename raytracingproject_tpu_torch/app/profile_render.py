"""Where the render's time goes on the card.

    python -m raytracingproject_tpu_torch.app.profile_render \\
        [--scene glossy|glossy_fused|volume_sss|big_instanced|cornell|
                 volume_sss_dense|big_instanced_onehot2|dof_motion|
                 textured_instanced|instanced_grid6|instanced_grid5_nlat15|
                 instanced_grid5_nlat15_fused|glossy_deform|
                 glossy_deform_tile|cornell_deform|glossy_deform_big|
                 glossy_deform_big_onehot2]
        [--device cuda]
        [--out profile.json]

Renders one configuration of chip_smoke.py at its full width, one lane
per pixel, chunk by chunk through ops/integrator.py
render_samples_regen: `glossy` is the glossy Cornell box
(example:cornell:glossy) at 512x512 through K2 and K3, `glossy_fused`
the same in fused-NEE mode (example:cornell:glossy:fused), where one call
of the union walk K7 per iteration answers the shadow test and the next
closest hit (and one more per chunk traces the first camera rays);
`volume_sss` is
example:volume_sss at 256x256 with its pinned dispatch
(examples.VOLUME_SSS_DISPATCH) through K4 and K3's dual form;
`big_instanced` is example:big_instanced at 256x256 through K5, which
answers both the closest hit and the NEE shadow test (two calls per
iteration), `big_instanced_onehot2` the same through K6; `cornell` is
example:cornell (36 prims) at 512x512 through the dense sweep K1, closest
mode and, for the shadow test, any-hit mode; `volume_sss_dense` is
example:volume_sss:dense at 256x256 through K1's closest mode and its dual
form; `dof_motion` is example:dof_motion at 256x256 (lens and motion camera
rays on the glossy box) through K2 and K3, chunk by chunk as its fixed
render runs; `textured_instanced` is example:textured_instanced at 256x256
(instanced_scene at grid=4, compiled flattened: 385 clusters x 30
triangles) through K2 and K3; `instanced_grid6` is example:instanced_grid6
at 256x256 (577 clusters x 38 triangles with instance rows) through K4
and K3, `instanced_grid5_nlat15` example:instanced_grid5_nlat15 (401 x
48 with instance rows) through K2 and K3, `instanced_grid5_nlat15_fused`
the same in fused-NEE mode through K7; `glossy_deform` is
example:glossy_deform at 256x256 (motion cluster rows, 179 x 15) through
K2 and K3, `glossy_deform_tile` the same through K4 and K3, and
`cornell_deform` example:cornell_deform at 256x256 (36 prims on a
three-step path) through K1's deform modes, closest and any hit;
`glossy_deform_big` is example:glossy_deform_big at 256x256 (two-level
motion tables, 936 x 64) through K5, which answers both the closest hit
and the shadow test, `glossy_deform_big_onehot2` the same through K6.

1. a warm-up chunk of 4 samples (builds the kernels);
2. one chunk of 16 samples on the host clock, ending in a device
   synchronize: wavefront iterations (launches of the closest-hit walk over
   its calls per iteration) and ms per iteration;
3. one chunk of 4 samples under torch.profiler (CPU and CUDA
   activities). From the device events of key_averages(): device kernels
   per iteration, device busy time, the device idle share (1 - busy / wall
   time of the profiled chunk), the per-call device time of the walk and
   of the shadow-test kernel in the render, the walk's share of an
   iteration, and the device kernels that take the most time.

Prints one JSON object as its last line, and writes it to --out if given.
On a CPU device the walks take their plain versions and launch no kernel,
so the iteration counts read 0 and the device figures are null.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

K3_KERNEL = "occlusion_walk_kernel"
# K1's modes are one template, dense_kernel<MODE, ...>
K1_CLOSEST, K1_ANY, K1_DUAL = ("dense_kernel<0", "dense_kernel<1",
                               "dense_kernel<2")
TOP = 12   # device kernels listed, by total time
# scene -> (example spec, width, closest-hit walk module, its kernel name,
# the walk's calls per wavefront iteration, the shadow-test kernel where
# it is another one, the walk's calls per chunk outside the iterations)
SCENES = {
    "glossy": ("example:cornell:glossy", 512, "cluster_walk",
               "cluster_walk_kernel", 1, K3_KERNEL, 0),
    # K7 answers the shadow test and the next closest hit of every
    # iteration, and the first camera rays of the chunk
    "glossy_fused": ("example:cornell:glossy:fused", 512, "dual_walk",
                     "dual_walk_kernel", 1, None, 1),
    "volume_sss": ("example:volume_sss", 256, "tile_walk",
                   "tile_walk_kernel", 1, K3_KERNEL, 0),
    # K5 (or K6) answers the closest hit and the shadow test of every
    # iteration
    "big_instanced": ("example:big_instanced", 256, "cluster2_walk",
                      "cluster2_walk_kernel", 2, None, 0),
    "big_instanced_onehot2": ("example:big_instanced:onehot2", 256,
                              "onehot2_walk", "onehot2_walk_kernel", 2, None,
                              0),
    "cornell": ("example:cornell", 512, "dense_sweep", K1_CLOSEST, 1,
                K1_ANY, 0),
    "volume_sss_dense": ("example:volume_sss:dense", 256, "dense_sweep",
                         K1_CLOSEST, 1, K1_DUAL, 0),
    "dof_motion": ("example:dof_motion", 256, "cluster_walk",
                   "cluster_walk_kernel", 1, K3_KERNEL, 0),
    "textured_instanced": ("example:textured_instanced", 256,
                           "cluster_walk", "cluster_walk_kernel", 1,
                           K3_KERNEL, 0),
    "instanced_grid6": ("example:instanced_grid6", 256, "tile_walk",
                        "tile_walk_kernel", 1, K3_KERNEL, 0),
    "instanced_grid5_nlat15": ("example:instanced_grid5_nlat15", 256,
                               "cluster_walk", "cluster_walk_kernel", 1,
                               K3_KERNEL, 0),
    "instanced_grid5_nlat15_fused": ("example:instanced_grid5_nlat15:fused",
                                     256, "dual_walk", "dual_walk_kernel", 1,
                                     None, 1),
    "glossy_deform": ("example:glossy_deform", 256, "cluster_walk",
                      "cluster_walk_kernel", 1, K3_KERNEL, 0),
    "glossy_deform_tile": ("example:glossy_deform:tile", 256, "tile_walk",
                           "tile_walk_kernel", 1, K3_KERNEL, 0),
    "cornell_deform": ("example:cornell_deform", 256, "dense_sweep",
                       K1_CLOSEST, 1, K1_ANY, 0),
    "glossy_deform_big": ("example:glossy_deform_big", 256, "cluster2_walk",
                          "cluster2_walk_kernel", 2, None, 0),
    "glossy_deform_big_onehot2": ("example:glossy_deform_big:onehot2", 256,
                                  "onehot2_walk", "onehot2_walk_kernel", 2,
                                  None, 0),
}


def _launches(walk):
    """The closest-hit launches of a walk module (K1 counts per mode)."""
    n = walk.launches
    return n["closest"] if isinstance(n, dict) else n


def build_parser():
    p = argparse.ArgumentParser(
        prog="raytracingproject_tpu_torch.app.profile_render",
        description="profile one chunk of a full-width render")
    p.add_argument("--scene", default="glossy", choices=sorted(SCENES))
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _device_events(prof):
    """(name, calls, total us) of every device-side event average."""
    from torch.autograd import DeviceType
    return [(e.key, e.count, float(e.self_device_time_total))
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]


def profile(scene="glossy", width=None, spp=16, profile_spp=4,
            device="cuda"):
    """Run the three phases (host-clocked chunk of `spp` samples, warm-up
    and profiled chunks of `profile_spp`); returns the findings."""
    import importlib
    from raytracingproject_tpu_torch.app import cli
    from raytracingproject_tpu_torch.device import get_device
    from raytracingproject_tpu_torch.ops import integrator as integ
    from raytracingproject_tpu_torch.session.session import pixel_wavefront
    (spec, full_width, walk_name, walk_kernel, per_iter, shadow_kernel,
     per_chunk) = SCENES[scene]
    walk = importlib.import_module(
        f"raytracingproject_tpu_torch.ops.{walk_name}")
    width = width or full_width
    dev = get_device(device)
    sc, flags = cli.load_scene(spec)
    sc.camera.set("width", width)
    sc.camera.set("height", width)
    sc.device_update()
    kg = sc.make_kernel_globals(dev)
    kg.update(flags)
    px, py, pidx = pixel_wavefront(width, width, 1, dev)

    def chunk(start, n):
        before = _launches(walk)
        integ.render_samples_regen(kg, px, py, pidx, start, n)
        _sync(dev)
        return max(_launches(walk) - before - per_chunk, 0) // per_iter

    # ---- 1. warm-up ----
    chunk(0, profile_spp)

    # ---- 2. host clock around one chunk ----
    t0 = time.perf_counter()
    iters = chunk(0, spp)
    wall = time.perf_counter() - t0
    out = {"scene": spec, "width": width,
           "lanes": width * width, "device": str(dev),
           "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "chunk_spp": spp, "chunk_s": wall, "chunk_iterations": iters,
           "ms_per_iteration": (1e3 * wall / iters) if iters else None}

    # ---- 3. torch.profiler around one chunk ----
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        p_iters = chunk(0, profile_spp)
        p_wall = time.perf_counter() - t0
    events = _device_events(prof)
    out.update({"profiled_spp": profile_spp, "profiled_s": p_wall,
                "profiled_iterations": p_iters})
    if not events:
        out.update({"device_busy_s": None, "device_idle_share": None,
                    "device_kernels_per_iteration": None,
                    "walk_ms_per_call": None, "shadow_ms_per_call": None,
                    "shadow_calls_per_iteration": None,
                    "top_kernels": []})
        return out
    busy_us = sum(t for _n, _c, t in events)
    calls = sum(c for _n, c, _t in events)

    def per_call(name):
        """(calls, device ms per call) of the kernels named `name`."""
        hit = [(c, t) for n, c, t in events if name and name in n]
        c = sum(c for c, _t in hit)
        return c, ((sum(t for _c, t in hit) / c / 1e3) if c else None)

    events.sort(key=lambda e: -e[2])
    out.update({
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / p_wall,
        "device_kernels_per_iteration": (calls / p_iters) if p_iters else None,
        "walk_kernel": walk_kernel,
        "walk_ms_per_call": per_call(walk_kernel)[1],
        "shadow_kernel": shadow_kernel,
        "shadow_ms_per_call": per_call(shadow_kernel)[1],
        "shadow_calls_per_iteration": (per_call(shadow_kernel)[0] / p_iters
                                       if p_iters else None),
        "walk_calls_per_iteration": per_iter,
        "walk_share_of_iteration": None,
        "walk_shadow_share_of_iteration": None,
        "top_kernels": [{"name": n[:120], "calls": c, "ms": t / 1e3}
                        for n, c, t in events[:TOP]]})
    if out["ms_per_iteration"] and out["walk_ms_per_call"]:
        out["walk_share_of_iteration"] = (
            out["walk_ms_per_call"] * per_iter / out["ms_per_iteration"])
    if out["ms_per_iteration"] and out["walk_ms_per_call"] \
            and out["shadow_ms_per_call"]:
        out["walk_shadow_share_of_iteration"] = (
            (out["walk_ms_per_call"] * per_iter + out["shadow_ms_per_call"]
             * out["shadow_calls_per_iteration"]) / out["ms_per_iteration"])
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = profile(args.scene, device=args.device)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
