"""Command line (JAX counterpart: raytracingproject_tpu/app/cli.py).

  python -m raytracingproject_tpu_torch example:cornell \\
      --samples 64 --width 512 --height 512 --chunk 32 --device cuda
  python -m raytracingproject_tpu_torch example:cornell:glossy[:fused] \\
      --samples 64 --width 512 --height 512 --device cuda --output out.png
  python -m raytracingproject_tpu_torch example:volume_sss[:dense] \\
      --samples 32 --width 256 --height 256 --device cuda
  python -m raytracingproject_tpu_torch example:big_instanced[:onehot2] \\
      --samples 16 --width 256 --height 256 --chunk 8 --device cuda

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
                   "'example:big_instanced[:onehot2]'")
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
    if parts == ["example", "cornell", "glossy", "fused"]:
        return examples.cornell_box(spheres="glossy"), examples.GLOSSY_FUSED
    if parts[:2] != ["example", "cornell"] or len(parts) > 3:
        raise SystemExit(f"unknown scene '{spec}' (try example:cornell, "
                         "example:cornell:glossy[:fused], "
                         "example:volume_sss or example:big_instanced)")
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
    img = render(scene, samples, chunk=args.chunk, device=dev,
                 lanes_per_pixel=args.lanes_per_pixel, kg=kg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    w, h = int(scene.camera.width), int(scene.camera.height)
    return img, {"width": w, "height": h, "samples": samples,
                 "compile_s": t1 - t0, "render_s": t2 - t1,
                 "msamples_per_s": w * h * samples / (t2 - t1) / 1e6}


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
