"""Command line (JAX counterpart: raytracingproject_tpu/app/cli.py).

  python -m raytracingproject_tpu_torch example:cornell \\
      --samples 64 --width 512 --height 512 --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch example:cornell:glossy[:fused] \\
      --samples 64 --width 512 --height 512 --device cuda --output out.png
  python -m raytracingproject_tpu_torch example:volume_sss[:dense] \\
      --samples 32 --width 256 --height 256 --device cuda
  python -m raytracingproject_tpu_torch example:big_instanced[:onehot2] \\
      --samples 16 --width 256 --height 256 --chunk 8 --device cuda
  python -m raytracingproject_tpu_torch example:dof_motion \\
      --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch example:textured_instanced \\
      --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch example:instanced_grid6 \\
      --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch \\
      example:instanced_grid5_nlat15[:fused] --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch example:glossy_deform[:tile] \\
      --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch example:cornell_deform \\
      --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch example:glossy_deform_big[:onehot2] \\
      --chunk 32 --device cuda

Renders an example scene with the port and prints Msamples/s (pixels x
samples over the render's wall time, host compile excluded).
example:cornell is the Cornell box with its two boxes (36 prims: the dense
sweep K1 for every closest hit and shadow test). example:cornell:glossy
is the glossy_nee_mis configuration (K2 for the closest hit, K3 for the
shadow test); example:cornell:glossy:fused renders it in fused-NEE mode
(examples.GLOSSY_FUSED: one union walk K7 per bounce for both).
example:volume_sss renders with its pinned dispatch
(examples.VOLUME_SSS_DISPATCH: K4 walk, K3 occlusion),
example:volume_sss:dense with the host compile's own choice for its 1,008
prims (K1 in its closest and dual forms).
example:big_instanced is instanced_scene(grid=8), the two-level instanced
scene (K5 for every closest hit and shadow test); example:big_instanced:
onehot2 opts into K6 for both (examples.BIG_INSTANCED_ONEHOT2).
example:dof_motion is the dof_motion_adaptive configuration
(dof_motion_scene at 256x256, 64 spp: the glossy box through a six-bladed
lens from a moving camera, K2 and K3 as for glossy); the scene declares
adaptive sampling, so it renders through the session's adaptive branch,
and Msamples/s counts the nominal budget (pixels x samples) over the wall
time, with the samples actually rendered beside it.
example:textured_instanced is the textured_instanced configuration
(instanced_scene at its default grid=4, 256x256, 64 spp: 16 image-textured
spheres on a checkered ground under a distant sun and a sky, 8,450 prims
compiled flattened, the BVH built by the port's C++ builder; K2 for the
closest hit, K3 for the shadow test).
example:instanced_grid6 is instanced_scene(grid=6) at textured_instanced's
256x256, 64 spp: 36 spheres, 19,010 flat prims, over the flatten limit,
so the sphere stays instanced in a single-level table of 577 clusters x
38 triangles with instance rows (K4 for the closest hit, K3 for the
shadow test). example:instanced_grid5_nlat15 is instanced_scene(grid=5,
nlat=15) alike (25 spheres of 672 triangles, 401 clusters x 48: K2 and
K3); with :fused it renders in fused-NEE mode (examples.FUSED_NEE: K7).
example:glossy_deform is the glossy box with its mirror sphere deforming
over the shutter (256x256, 64 spp; motion cluster rows, 179 clusters x
15: K2 for the closest hit, K3 for the shadow test, both at each ray's
time); with :tile the closest hit takes K4 (examples.GLOSSY_DEFORM_TILE).
example:cornell_deform is the Cornell box with its short box on a
three-step path (36 prims: K1's deform modes).
example:glossy_deform_big is glossy_deform with a 41,580-triangle mirror
sphere (256x256, 64 spp; two-level motion tables, 936 clusters x 64 in 25
superclusters: K5 for the closest hit and the shadow test, at each ray's
time); with :onehot2 both take K6 (examples.GLOSSY_DEFORM_BIG_ONEHOT2).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def build_parser():
    p = argparse.ArgumentParser(
        prog="raytracingproject_tpu_torch",
        description="PyTorch/CUDA port of the path tracer")
    p.add_argument("scene",
                   help="'example:cornell[:variant]' | "
                   "'example:cornell:glossy:fused' | "
                   "'example:volume_sss[:dense]' | "
                   "'example:big_instanced[:onehot2]' | "
                   "'example:dof_motion' | "
                   "'example:textured_instanced' | "
                   "'example:instanced_grid6' | "
                   "'example:instanced_grid5_nlat15[:fused]' | "
                   "'example:glossy_deform[:tile]' | "
                   "'example:cornell_deform' | "
                   "'example:glossy_deform_big[:onehot2]'")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--chunk", type=int, default=16,
                   help="samples per render_samples_regen call")
    p.add_argument("--lanes-per-pixel", type=int, default=1)
    p.add_argument("--output", default="out.png")
    p.add_argument("--quiet", action="store_true")
    return p


def load_scene(spec):
    """(scene, kernel-globals flags) for an example scene spec."""
    from raytracingproject_tpu_torch.app import examples
    parts = spec.split(":")
    if parts == ["example", "volume_sss"]:
        return examples.volume_sss_scene(), examples.VOLUME_SSS_DISPATCH
    if parts == ["example", "volume_sss", "dense"]:
        return examples.volume_sss_scene(), {}
    if parts[:2] == ["example", "big_instanced"] \
            and parts[2:] in ([], ["onehot2"]):
        return (examples.instanced_scene(256, 256, spp=16, grid=8),
                examples.BIG_INSTANCED_ONEHOT2 if parts[2:] else {})
    if parts == ["example", "dof_motion"]:
        return examples.dof_motion_scene(256, 256, spp=64), {}
    if parts == ["example", "textured_instanced"]:
        return examples.instanced_scene(256, 256, spp=64), {}
    if parts == ["example", "instanced_grid6"]:
        return examples.instanced_scene(256, 256, spp=64, grid=6), {}
    if parts[:2] == ["example", "instanced_grid5_nlat15"] \
            and parts[2:] in ([], ["fused"]):
        return (examples.instanced_scene(256, 256, spp=64, grid=5, nlat=15),
                examples.FUSED_NEE if parts[2:] else {})
    if parts[:2] == ["example", "glossy_deform"] \
            and parts[2:] in ([], ["tile"]):
        return (examples.glossy_deform_scene(256, 256, spp=64),
                examples.GLOSSY_DEFORM_TILE if parts[2:] else {})
    if parts == ["example", "cornell_deform"]:
        return examples.cornell_deform_scene(256, 256, spp=64), {}
    if parts[:2] == ["example", "glossy_deform_big"] \
            and parts[2:] in ([], ["onehot2"]):
        return (examples.glossy_deform_big_scene(256, 256, spp=64),
                examples.GLOSSY_DEFORM_BIG_ONEHOT2 if parts[2:] else {})
    if parts == ["example", "cornell", "glossy", "fused"]:
        return examples.cornell_box(spheres="glossy"), examples.GLOSSY_FUSED
    if parts[:2] != ["example", "cornell"] or len(parts) > 3:
        raise SystemExit(f"unknown scene '{spec}' (try example:cornell, "
                         "example:cornell:glossy[:fused], "
                         "example:volume_sss, example:big_instanced, "
                         "example:dof_motion, example:textured_instanced, "
                         "example:instanced_grid6, "
                         "example:instanced_grid5_nlat15[:fused], "
                         "example:glossy_deform[:tile], "
                         "example:cornell_deform or "
                         "example:glossy_deform_big[:onehot2])")
    return (examples.cornell_box(spheres=parts[2] if len(parts) > 2
                                 else None), {})


def run(args):
    """Render per the parsed CLI args; returns (image, stats dict)."""
    from raytracingproject_tpu_torch.device import get_device
    from raytracingproject_tpu_torch.session.session import render
    dev = get_device(args.device)
    scene, flags = load_scene(args.scene)
    if args.width:
        scene.camera.set("width", args.width)
    if args.height:
        scene.camera.set("height", args.height)
    samples = args.samples or int(scene.integrator.aa_samples)
    t0 = time.perf_counter()
    scene.device_update()
    kg = scene.make_kernel_globals(dev)
    kg.update(flags)
    t1 = time.perf_counter()
    rs = {}
    img = render(scene, samples, chunk=args.chunk, device=dev,
                 lanes_per_pixel=args.lanes_per_pixel, kg=kg, stats=rs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    w, h = int(scene.camera.width), int(scene.camera.height)
    return img, {"width": w, "height": h, "samples": samples,
                 "compile_s": t1 - t0, "render_s": t2 - t1,
                 "msamples_per_s": w * h * samples / (t2 - t1) / 1e6, **rs}


def main(argv=None):
    args = build_parser().parse_args(argv)
    img, st = run(args)
    from raytracingproject_tpu_torch.utils import image_io
    image_io.write_png(args.output, img)
    if not args.quiet:
        dev = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
               else "cpu")
        print(f"wrote {args.output} ({st['width']}x{st['height']}"
              f"@{st['samples']}spp on {dev}): "
              f"{st['msamples_per_s']:.4f} Msamples/s "
              f"(render {st['render_s']:.2f} s, host compile "
              f"{st['compile_s']:.2f} s)", file=sys.stderr)
        if st["adaptive"]:
            print(f"adaptive: {st['samples_rendered']} of "
                  f"{st['samples_nominal']} samples rendered; Msamples/s "
                  "counts the nominal budget", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
