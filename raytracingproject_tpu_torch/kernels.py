"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source goes through its own nvcc call into a shared library with a
plain C interface, loaded with ctypes; the calls run in parallel:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -o build/torch_kernels/<name>_<hash>.so
         csrc/<name>.cu

The libraries are built at first use into build/torch_kernels/ under the
repository root, each named by a hash of its source, the shared headers
and the flags, so an edit rebuilds and an unchanged tree reuses them.
-fmad=false keeps every multiply and add separate, so the kernels round
like the plain torch versions they are tested against. Each C entry point
launches on the stream it is given and returns cudaGetLastError().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# single-level closest-hit walks (K2, K4): cbounds ctable C W ct o d tmin
# tmax vis n any_hit instances motion time t prim u v obj counts stream
# (time: (N,) f32 or null; counts: (N, 2) for K2, (N, 4) for K4, int32, or
# null: the counting variant runs when given)
_WALK = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
         _P, _P, _P, _P, _P, _P, _P]
# two-level walks (K5, K6): sc_bounds cbounds ctable SC C W ct gmax o d
# tmin tmax vis n any_hit instances motion time t prim u v obj counts stream
_WALK2 = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
          _I, _P, _P, _P, _P, _P, _P, _P, _P]
# source -> {C entry point: argtypes}
SIGNATURES = {
    "cluster_walk.cu": {"rt_cluster_walk": _WALK},
    # cbounds ctable cboundary C W ct o d tmin tmaxc tmaxa n vis_c vis_a
    # instances motion time tb to blocked counts stream
    "occlusion_walk.cu": {"rt_occlusion_walk": [
        _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
        _P, _P, _P, _P, _P]},
    "tile_walk.cu": {"rt_tile_walk": _WALK},
    # sc_bounds cbounds ctable SC C W ct gmax o d tmin tmax vis n any_hit
    # instances motion time t prim u v obj counts stream (time: (N,) f32 or
    # null; counts: (N, 6) int32 or null)
    "cluster2_walk.cu": {"rt_cluster2_walk": _WALK2},
    # K6 takes K5's arguments (counts: (N, 8) int32 or null)
    "onehot2_walk.cu": {"rt_onehot2_walk": _WALK2},
    # cbounds ctable C W ct | o d tmin tmax vis of the closest ray | the
    # same of the any-hit ray | n instances t prim u v obj blocked counts
    # stream
    "dual_walk.cu": {"rt_dual_walk": [
        _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P]},
    "dense_sweep.cu": {
        # tri_verts prim_object obj_vis P o d tmin tmax vis n t prim u v obj
        # counts steps S1 time stream (counts: (N, 3) int32 or null, as
        # K2's; steps (S1, P, 3, 3) and time (N,) f32 or null: the deform
        # modes run when given)
        "rt_dense_closest": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                             _P, _P, _P, _P, _P, _P, _P, _I, _P, _P],
        # ... n blocked counts steps S1 time stream
        "rt_dense_any": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                         _P, _I, _P, _P],
        # tri_verts prim_object obj_vis boundary P o d tmin tmaxc tmaxa visc
        # visa n tb to blocked counts steps S1 time stream
        "rt_dense_dual": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                          _I, _P, _P, _P, _P, _P, _I, _P, _P],
        # v0 e1 e2 P o d tmin tmax n t prim u v stream
        "rt_dense_mt": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                        _P]},
}

_lib = None
_lock = threading.Lock()
build_info = {}   # wall seconds, paths, ptxas log of the last build


class _Kernels:
    """The C entry points of every loaded library, as attributes."""

    def __init__(self, fns):
        self.__dict__.update(fns)


def nvcc_path():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _out_path(cu, headers):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in headers + [cu]:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    name = os.path.basename(cu)[:-3]
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build():
    """Compile every csrc/*.cu not built yet, all nvcc calls at once;
    returns {source file name: library path}."""
    srcs = sources()
    headers = [s for s in srcs if s.endswith(".cuh")]
    outs = {os.path.basename(cu): _out_path(cu, headers)
            for cu in srcs if cu.endswith(".cu")}
    todo = {k: p for k, p in outs.items() if not os.path.exists(p)}
    t0 = time.perf_counter()
    logs = []
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name, out in todo.items():
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for name, (p, tmp, out) in procs.items():
            log = p.communicate()[0]
            logs.append(f"== {name}\n{log}")
            if p.returncode != 0:
                failed.append(f"{name} ({p.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    build_info.update(paths=outs, seconds=time.perf_counter() - t0,
                      built=sorted(todo), log="\n".join(logs) or "(cached)")
    return outs


def load():
    """The loaded kernels (building them on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            fns = {}
            for name, path in build().items():
                lib = ctypes.CDLL(path)
                for fn_name, argtypes in SIGNATURES.get(name, {}).items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[fn_name] = fn
            _lib = _Kernels(fns)
    return _lib


def current_stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def check_rc(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(cond, msg):
    """An argument check: wrong device, dtype, shape or contiguity."""
    if not cond:
        raise ValueError(msg)


def unsupported(cond, msg):
    """A capacity check: more clusters than a kernel takes, or tables past
    its shared memory. What lies outside the port raises
    NotImplementedError, as the package promises."""
    if not cond:
        raise NotImplementedError(msg)
