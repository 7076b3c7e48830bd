"""Msamples/s of the same full-width cells rendered by two checkouts of
the repository on one card, in turns.

    python3 compare_trees.py A_DIR B_DIR \
        [--rounds 3] [--cells SPEC,SPEC] [--out FILE.json]

Each round renders every cell once with each checkout, each in a process
of its own started in that checkout (so with its own
raytracingproject_tpu_torch and its own kernel build): A then B in odd
rounds, B then A in even ones. Before each timed render a 32x32 render of
the same cell builds and loads the kernels. The cells: cornell_diffuse
512x512x64 chunk 32 and volume_sss under the dense dispatch 256x256x32
chunk 16 (the dense sweep K1), glossy_nee_mis 512x512x64 chunk 16 fused
(K7) and unfused (K2 + K3), volume_sss under its pinned dispatch
256x256x32 chunk 16 (K4 + K3) and big_instanced 256x256x16 chunk 8 (K5);
--cells picks some of them by their example spec. Prints the card's name
and power limit, one JSON line per process, and per cell and checkout the
median, min and max over the rounds. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CELLS = (("example:cornell", 512, 64, 32),
         ("example:volume_sss:dense", 256, 32, 16),
         ("example:cornell:glossy:fused", 512, 64, 16),
         ("example:cornell:glossy", 512, 64, 16),
         ("example:volume_sss", 256, 32, 16),
         ("example:big_instanced", 256, 16, 8))

# run in the checkout's own directory: only its CLI, which every checkout
# of the port has
_RENDER = """
import json, sys
sys.path.insert(0, ".")
from raytracingproject_tpu_torch.app import cli
cells = json.loads(sys.argv[1])
out = {}
for spec, w, spp, chunk in cells:
    for size, n, c in ((32, 1, 1), (w, spp, chunk)):
        args = cli.build_parser().parse_args(
            [spec, "--samples", str(n), "--width", str(size), "--height",
             str(size), "--chunk", str(c), "--lanes-per-pixel", "1",
             "--device", "cuda", "--quiet", "--output", "/dev/null"])
        _img, st = cli.run(args)
    out[spec] = st["msamples_per_s"]
print("RENDERS " + json.dumps(out), flush=True)
"""


def render_in(tree, cells):
    """{cell: Msamples/s} of one process in checkout `tree`."""
    r = subprocess.run([sys.executable, "-c", _RENDER, json.dumps(cells)],
                       cwd=tree, capture_output=True, text=True, check=True)
    line = [x for x in r.stdout.splitlines() if x.startswith("RENDERS ")][-1]
    return json.loads(line[len("RENDERS "):])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--cells", default=None,
                   help="comma-separated example specs (default: all)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cells = CELLS
    if args.cells:
        names = args.cells.split(",")
        cells = tuple(c for c in CELLS if c[0] in names)
        if len(cells) != len(names):
            p.error(f"--cells: the cells are {[c[0] for c in CELLS]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    runs = {k: [] for k in trees}
    for r in range(args.rounds):
        for k in (("a", "b") if r % 2 == 0 else ("b", "a")):
            runs[k].append(render_in(trees[k], cells))
            print(json.dumps({"round": r + 1, "tree": trees[k],
                              "msamples_per_s": runs[k][-1]}), flush=True)
    summary = {}
    for spec, *_ in cells:
        summary[spec] = {}
        for k, tree in trees.items():
            x = [run[spec] for run in runs[k]]
            summary[spec][k] = {"tree": tree, "median": float(np.median(x)),
                                "min": min(x), "max": max(x), "runs": x}
            print(f"{spec} {k} ({tree}): median {np.median(x):.4f}, "
                  f"{min(x):.4f}-{max(x):.4f} Msamples/s over {len(x)} "
                  f"renders ({card})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "cells": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
