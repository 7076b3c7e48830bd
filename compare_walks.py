"""K4 and K5, the tile-shared walks, or K6, the two-level per-lane walk,
of an earlier checkout and of this one on one card, on the inputs of the
full-width renders and at the caps.

    python3 compare_walks.py PARENT_DIR [--kernel k45|k6] \
        [--queues 2,4,8,16] [--gqueues 4,8,16] [--no-time] [--out FILE.json]

PARENT_DIR is a checkout of the earlier design (for instance the parent
commit unpacked with `git archive` into build/parent). The script

1. builds PARENT_DIR's kernels and this tree's at each queue length, with
   kernels.py's nvcc flags, one nvcc call each, all started together,
   into build/compare_walks/, and prints each kernel's registers and
   spills (ptxas -v): with --kernel k45 (the default) csrc/tile_walk.cu
   and csrc/cluster2_walk.cu at each q of --queues (-DK4_QUEUE=q
   -DK5_QUEUE=q); with --kernel k6 csrc/onehot2_walk.cu at each q of
   --queues and each g of --gqueues (-DK6_QUEUE=q -DK6_GQUEUE=g);
2. records the inputs of the third K4 call of volume_sss 256x256x32
   chunk 16 (examples.VOLUME_SSS_DISPATCH) and of the third closest-hit
   and the third any-hit K5 call of big_instanced 256x256x16 chunk 8 (k6:
   of K6 in example:big_instanced:onehot2), each render stopped once its
   calls are copied, and builds the 640-cluster grid table
   (ops/tile_walk.py grid_tables; k6: the two-level table at the caps,
   512 superclusters of 16 clusters, ops/onehot2_walk.py grid_tables2)
   with 65,536 random rays around it, closest and any hit;
3. on each input runs the scan-order mirror (ops/tile_walk.py
   tile_scan_order, ops/cluster2_walk.py cluster2_scan_order,
   ops/onehot2_walk.py onehot2_scan_order: the earlier design's visit
   order and counts) and the queue-order mirror at each queue length, and
   holds both designs' kernels to them: t, u, v equal to the plain
   version's to the bit off exact-t ties (closest hit), every output equal
   to the scan mirror's on every lane, ties included, and this tree's
   counting variant's counts equal to the queue mirror's at its lengths;
4. unless --no-time, times every kernel three times, each the median of
   20 runs (CUDA events), in turns.

Prints the card's name and power limit beside every time and writes
everything to --out as JSON; exits 1 if any check failed. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from chip_smoke import log

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"k45": ("tile_walk.cu", "cluster2_walk.cu"),
           "k6": ("onehot2_walk.cu",)}
ENTRY = {"tile_walk.cu": "rt_tile_walk", "cluster2_walk.cu": "rt_cluster2_walk",
         "onehot2_walk.cu": "rt_onehot2_walk"}
RUNS = 20
SPAN = 30.0 * 9   # the grid table's extent (ops/tile_walk.py grid_tables)


class _Recorded(Exception):
    """Stops a render once the calls it was run for are copied."""


def _kernels_module(tree):
    """`tree`'s raytracingproject_tpu_torch/kernels.py (stdlib imports
    only), loaded under a name of its own."""
    path = os.path.join(tree, "raytracingproject_tpu_torch", "kernels.py")
    spec = importlib.util.spec_from_file_location(
        f"_kernels_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def designs(kernel, queues, gqueues):
    """{design: (its -D flags, its queue mirror's keyword arguments)} of
    this tree's kernels: "Q<q>" (k45) or "Q<q>G<g>" (k6)."""
    if kernel == "k45":
        return {f"Q{q}": ([f"-DK4_QUEUE={q}", f"-DK5_QUEUE={q}"],
                          {"queue": q}) for q in queues}
    return {f"Q{q}G{g}": ([f"-DK6_QUEUE={q}", f"-DK6_GQUEUE={g}"],
                          {"queue": q, "gqueue": g})
            for q in queues for g in gqueues}


def build(parent, kernel, plan):
    """{(design, source): C entry point}; design "parent" or one of
    `plan`'s."""
    from raytracingproject_tpu_torch import kernels
    out_dir = os.path.join(ROOT, "build", "compare_walks")
    os.makedirs(out_dir, exist_ok=True)
    mods = {"parent": _kernels_module(parent), "this": kernels}
    jobs = {}
    for src in SOURCES[kernel]:
        jobs[("parent", src)] = (mods["parent"], [])
        for design, (defs, _kw) in plan.items():
            jobs[(design, src)] = (kernels, defs)
    nvcc = kernels.nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for (design, src), (mod, defs) in jobs.items():
        out = os.path.join(out_dir, f"{design}_{src[:-3]}.so")
        procs[(design, src)] = (subprocess.Popen(
            [nvcc, *mod.NVCC_FLAGS, *defs, "-o", out,
             os.path.join(mod.SRC_DIR, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out, mod)
    fns = {}
    for key, (p, out, mod) in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line \
                    or "entry function" in line:
                log(f"[build] {key[0]} {key[1]}: {line.strip()}")
        fn = getattr(ctypes.CDLL(out), ENTRY[key[1]])
        fn.argtypes = mod.SIGNATURES[key[1]][ENTRY[key[1]]]
        fn.restype = ctypes.c_int
        fns[key] = fn
    log(f"[build] {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    return fns


def launch(fn, src, inp, counts=None):
    """One kernel call on input `inp`; a C entry point with a counts
    argument gets `counts` (or null). Returns the hit dict."""
    from raytracingproject_tpu_torch import kernels
    a = inp["args"]
    n = a["o"].shape[0]
    dev = a["o"].device
    out = {k: torch.empty(n, dtype=torch.float32 if k in ("t", "u", "v")
                          else torch.int32, device=dev)
           for k in ("t", "prim", "u", "v", "object")}
    ptr = {k: v.data_ptr() for k, v in a.items() if torch.is_tensor(v)}
    ray = [ptr[k] for k in ("o", "d", "tmin", "tmax", "visibility")]
    res = [out[k].data_ptr() for k in ("t", "prim", "u", "v", "object")]
    c, w = a["cbounds"].shape[0], a["ctable"].shape[1]
    if src == "tile_walk.cu":
        argv = [ptr["cbounds"], ptr["ctable"], c, w, int(a["cluster_tris"]),
                *ray,
                n, int(inp["any_hit"]), *res]
        extra = len(fn.argtypes) - len(argv) - 2   # past counts, stream
        if extra >= 1:
            # a tree whose K4 takes instance rows: a flag after any_hit
            argv.insert(12, int(bool(a.get("has_instances", False))))
        if extra == 3:
            # ... and motion rows: a flag and the lanes' times
            mot = bool(a.get("has_motion", False))
            argv[13:13] = [int(mot), ptr["time"] if mot else None]
    else:
        argv = [ptr["sc_bounds"], ptr["cbounds"], ptr["ctable"],
                a["sc_bounds"].shape[0], c, w, int(a["cluster_tris"]),
                int(a["gmax"]),
                *ray, n, int(inp["any_hit"]), 1, *res]
        if len(fn.argtypes) - len(argv) - 2 == 2:
            # a tree whose K5 / K6 take motion rows: a flag and the
            # lanes' times after the instance flag (instance rows here)
            argv[16:16] = [0, None]
    if len(fn.argtypes) == len(argv) + 2:
        argv.append(counts.data_ptr() if counts is not None else None)
    rc = fn(*argv, kernels.current_stream())
    kernels.check_rc(src, rc)
    return out


def record(spec, width, spp, chunk, name, want, device="cuda"):
    """Render `spec` through the CLI until wrapper `name` (a module of
    ops/) has made the calls of `want` ({label: (nth, any_hit)}: the nth
    call of that mode); returns {label: bound arguments}."""
    from raytracingproject_tpu_torch.app import cli
    mod = importlib.import_module(f"raytracingproject_tpu_torch.ops.{name}")
    fn_name = {"tile_walk": "intersect_clusters_tile",
               "cluster2_walk": "intersect_clusters2_walk",
               "onehot2_walk": "intersect_clusters2_onehot"}[name]
    orig = getattr(mod, fn_name)
    calls = {False: 0, True: 0}
    store = {}

    def recording(*args, **kw):
        any_hit = bool(kw.get("shadow_any_hit", False))
        calls[any_hit] += 1
        for label, (nth, mode) in want.items():
            if mode == any_hit and calls[any_hit] == nth:
                ba = inspect.signature(orig).bind(*args, **kw)
                ba.apply_defaults()
                store[label] = {k: v.clone() if torch.is_tensor(v) else v
                                for k, v in ba.arguments.items()}
        if len(store) == len(want):
            raise _Recorded
        return orig(*args, **kw)

    args = cli.build_parser().parse_args(
        [spec, "--samples", str(spp), "--width", str(width), "--height",
         str(width), "--chunk", str(chunk), "--lanes-per-pixel", "1",
         "--device", device])
    setattr(mod, fn_name, recording)
    try:
        cli.run(args)
    except _Recorded:
        pass
    finally:
        setattr(mod, fn_name, orig)
    assert len(store) == len(want), f"{spec}: calls not reached"
    return store


def inputs_k6(rng):
    """{label: {"src", "args", "any_hit"}}: K6's recorded render inputs
    and the two-level table at the caps under random rays."""
    from raytracingproject_tpu_torch.ops import onehot2_walk as k6
    rec = record("example:big_instanced:onehot2", 256, 16, 8, "onehot2_walk",
                 {"K6 closest big_instanced render": (3, False),
                  "K6 any big_instanced render": (3, True)})
    out = {}
    for label, a in rec.items():
        assert a["has_instances"]
        out[label] = {"src": "onehot2_walk.cu", "args": a,
                      "any_hit": bool(a["shadow_any_hit"])}
    sc, g, ct = cs.K6_CAP
    scb, cb, ctab = k6.grid_tables2(sc, g, ct, rng, "cuda")
    span = 100.0 * round(sc ** (1.0 / 3.0))
    n = 65536
    o, d = cs.random_rays(n, rng, "cuda", (-0.25 * span,) * 3,
                          (1.25 * span,) * 3)
    tmaxc = torch.tensor(rng.uniform(10, 2 * span, n).astype(np.float32),
                         device="cuda")
    tmaxa = torch.tensor(np.where(rng.uniform(size=n) < 0.5,
                                  rng.uniform(10, span, n), 1e30)
                         .astype(np.float32), device="cuda")
    for mode, tmax in (("closest", tmaxc), ("any", tmaxa)):
        out[f"K6 {mode} at {sc} superclusters"] = {
            "src": "onehot2_walk.cu", "any_hit": mode == "any",
            "args": {"sc_bounds": scb, "cbounds": cb, "ctable": ctab,
                     "cluster_tris": ct, "gmax": g, "o": o, "d": d,
                     "tmin": torch.full((n,), 1e-4, device="cuda"),
                     "tmax": tmax, "visibility": torch.ones(
                         n, dtype=torch.int32, device="cuda")}}
    return out


def inputs(rng):
    """{label: {"src", "args", "any_hit"}}: the recorded render inputs and
    the 640-cluster grid table's random rays."""
    from raytracingproject_tpu_torch.ops import tile_walk as tw
    out = {}
    rec = record("example:volume_sss", 256, 32, 16, "tile_walk",
                 {"K4 volume_sss render": (3, False)})
    for label, a in rec.items():
        out[label] = {"src": "tile_walk.cu", "args": a,
                      "any_hit": bool(a["shadow_any_hit"])}
    rec = record("example:big_instanced", 256, 16, 8, "cluster2_walk",
                 {"K5 closest big_instanced render": (3, False),
                  "K5 any big_instanced render": (3, True)})
    for label, a in rec.items():
        assert a["has_instances"]
        out[label] = {"src": "cluster2_walk.cu", "args": a,
                      "any_hit": bool(a["shadow_any_hit"])}
    cb, ctab, _ = tw.grid_tables(640, 15, rng, "cuda")
    n = 65536
    o = torch.tensor(rng.uniform(-0.25 * SPAN, 1.25 * SPAN, (n, 3))
                     .astype(np.float32), device="cuda")
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                     device="cuda")
    tmaxc = torch.tensor(rng.uniform(10, 2 * SPAN, n).astype(np.float32),
                         device="cuda")
    tmaxa = torch.tensor(np.where(rng.uniform(size=n) < 0.5,
                                  rng.uniform(10, SPAN, n), 1e30)
                         .astype(np.float32), device="cuda")
    for mode, tmax in (("closest", tmaxc), ("any", tmaxa)):
        out[f"K4 {mode} at 640 clusters"] = {
            "src": "tile_walk.cu", "any_hit": mode == "any",
            "args": {"cbounds": cb, "ctable": ctab, "cluster_tris": 15,
                     "o": o, "d": d,
                     "tmin": torch.full((n,), 1e-4, device="cuda"),
                     "tmax": tmax, "visibility": torch.ones(
                         n, dtype=torch.int32, device="cuda")}}
    return out


def mirrors(inp, plan):
    """(plain hit, scan mirror's (hit, counts[, warp steps]), {design:
    queue mirror's (hit, counts[, warp steps])})."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    a = inp["args"]
    walk = (a["cbounds"], a["ctable"], a["cluster_tris"], a["o"], a["d"],
            a["tmin"], a["tmax"], a["visibility"])
    plain = ci.intersect_clusters(*walk, shadow_any_hit=inp["any_hit"],
                                  has_instances="sc_bounds" in a)
    name = inp["src"][:-3]
    if "sc_bounds" in a:
        args = (a["sc_bounds"], *walk[:3], a["gmax"], *walk[3:])
    else:
        args = walk
    mod = cs.module(name)
    kw = {"shadow_any_hit": inp["any_hit"]}
    if name in cs.TWO_LEVEL:
        kw["has_instances"] = True
    queue = {design: getattr(mod, cs.ORDER_MIRRORS[name][1])(*args, **qkw,
                                                             **kw)
             for design, (_defs, qkw) in plan.items()}
    return plain, cs.order_mirror(name, args, inp["any_hit"]), queue


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("parent")
    p.add_argument("--kernel", choices=("k45", "k6"), default="k45")
    p.add_argument("--queues", default="2,4,8,16")
    p.add_argument("--gqueues", default="4,8,16",
                   help="K6's group-level queue lengths (--kernel k6)")
    p.add_argument("--no-time", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_walks: no CUDA card", file=sys.stderr)
        return 2
    from raytracingproject_tpu_torch.device import get_device
    from raytracingproject_tpu_torch.ops import cluster2_walk as k5
    from raytracingproject_tpu_torch.ops import onehot2_walk as k6
    from raytracingproject_tpu_torch.ops import tile_walk as k4
    get_device("cuda")   # TF32 off
    card = cs.card_line()
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    plan = designs(args.kernel, [int(q) for q in args.queues.split(",")],
                   [int(g) for g in args.gqueues.split(",")])
    lands = {"tile_walk.cu": f"Q{k4.QUEUE}",
             "cluster2_walk.cu": f"Q{k5.SC_QUEUE}",
             "onehot2_walk.cu": f"Q{k6.SC_QUEUE}G{k6.G_QUEUE}"}
    fns = build(os.path.abspath(args.parent), args.kernel, plan)
    rng = np.random.default_rng(11)
    report = {"card": card, "inputs": {}}
    failed = []
    fmt = lambda st: "; ".join(
        f"{k} " + "/".join(f"{v[q]:.2f}" for q in ("mean", "p50", "p99",
                                                   "max"))
        for k, v in st.items())
    for label, inp in (inputs_k6 if args.kernel == "k6"
                       else inputs)(rng).items():
        src = inp["src"]
        name = src[:-3]
        n = inp["args"]["o"].shape[0]
        plain, (scan, scnt, *ssteps), queue = mirrors(inp, plan)
        torch.cuda.synchronize()
        rep = report["inputs"][label] = {
            "lanes": n, "any_hit": inp["any_hit"],
            "hit": float((plain["prim"] >= 0).float().mean()),
            "scan_counts": cs.column_stats(scnt, cs.SCAN_COUNTS[name]),
            "queue_counts": {}, "checks": {}, "ms": {}}
        log(f"[{label}] {n} lanes, hit {rep['hit']:.4f}")
        log(f"[{label}] scan-order counts (mean/p50/p99/max): "
            f"{fmt(rep['scan_counts'])}")
        if ssteps:   # K6: the warp's inner steps against a lane's rows
            steps = float(ssteps[0].to(torch.float64).mean())
            rows = float(scnt[:, 4].to(torch.float64).mean())
            rep["warp_inner_steps_mean"] = steps
            rep["warp_steps_over_lane_rows"] = steps / max(rows, 1e-30)
            log(f"[{label}] the warp's inner steps {steps:.2f} a lane, rows "
                f"read {rows:.2f} a lane (ratio "
                f"{rep['warp_steps_over_lane_rows']:.2f})")
        # the counts both designs share: all but the scan's own (K4, K5)
        shared = (list(k6.SHARED_COUNTS) if name == "onehot2_walk"
                  else list(range(len(cs.SCAN_COUNTS[name]) - 1)))
        for design, (qhit, qcnt, *qsteps) in queue.items():
            same = all(torch.equal(qhit[k], scan[k]) for k in scan) and \
                torch.equal(qcnt[:, shared], scnt[:, shared]) and \
                all(torch.equal(a, b) for a, b in zip(qsteps, ssteps))
            rep["queue_counts"][design] = cs.column_stats(
                qcnt, cs.ORDER_COUNTS[name])
            log(f"[{label}] queue-order {design} (outputs and steps equal "
                f"the scan's: {same}): {fmt(rep['queue_counts'][design])}")
            if not same:
                failed.append(f"{label}: queue mirror {design} != scan "
                              "mirror")
        agree = (plain["prim"] == scan["prim"]) & \
            (plain["object"] == scan["object"])
        designs_ = ["parent"] + list(plan)
        for design in designs_:
            fn = fns[(design, src)]
            got = launch(fn, src, inp)
            torch.cuda.synchronize()
            diff = {k: int((got[k] != scan[k]).sum()) for k in scan}
            chk = {"lanes_differing_from_scan_mirror": diff,
                   "tie_lanes": int((~agree).sum())}
            ok = not any(diff.values())
            if not inp["any_hit"]:
                chk["tuv_equal_plain_off_ties"] = all(
                    torch.equal(got[k][agree], plain[k][agree])
                    for k in ("t", "u", "v"))
                ok = ok and chk["tuv_equal_plain_off_ties"]
            if design != "parent":
                cnt = torch.empty((n, len(cs.ORDER_COUNTS[name])),
                                  dtype=torch.int32, device="cuda")
                cgot = launch(fn, src, inp, cnt)
                torch.cuda.synchronize()
                chk["counts_equal_queue_mirror"] = bool(
                    torch.equal(cnt, queue[design][1]))
                chk["counting_outputs_equal"] = all(
                    torch.equal(cgot[k], got[k]) for k in got)
                ok = ok and chk["counts_equal_queue_mirror"] \
                    and chk["counting_outputs_equal"]
            rep["checks"][design] = chk
            log(f"[{label}] {design}: {'ok' if ok else 'FAILED'} {chk}")
            if not ok:
                failed.append(f"{label}: {design}")
        if args.no_time:
            continue
        runs = {dsg: [] for dsg in designs_}
        for r in range(3):
            for design in (designs_ if r % 2 == 0 else designs_[::-1]):
                fn = fns[(design, src)]
                runs[design].append(cs.median_ms(
                    lambda: launch(fn, src, inp), RUNS))
        for design, x in runs.items():
            rep["ms"][design] = {"median": float(np.median(x)),
                                 "min": min(x), "max": max(x), "runs": x}
            log(f"[time] {label} {design}: {np.median(x):.4f} ms "
                f"({min(x):.4f}-{max(x):.4f}, three timings of {RUNS} runs)"
                f"{' <- lands' if design == lands[src] else ''} "
                f"({card})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    for f in failed:
        log(f"[failed] {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
