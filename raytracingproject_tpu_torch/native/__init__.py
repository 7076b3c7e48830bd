"""The port's host C++: the binned-SAH BVH builder for 2,048 prims and more
(JAX counterpart: raytracingproject_tpu/native/__init__.py
build_bvh_native :137).

native/bvh_builder.cpp is built at first use, with one g++ call,

    g++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off
        -o build/torch_native/bvh_builder_<hash>.so native/bvh_builder.cpp

into build/torch_native/ under the repository root, named by a hash of the
source and the flags (as kernels.py names its CUDA builds), and loaded with
ctypes. -ffp-contract=off keeps every multiply and add separate, so the
bounds and SAH costs round as written. There is no NumPy fallback: the
NumPy builder's mask partition gives another tree at this size, so a
fallback would change the scene's tables; a failed build raises with
g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_native")
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]

_lib = None
_lock = threading.Lock()
build_info = {}   # wall seconds, path and whether g++ ran, of the last load

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)


def _out_path():
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(os.path.basename(SOURCE).encode() + f.read())
    return os.path.join(BUILD_DIR, f"bvh_builder_{h.hexdigest()[:16]}.so")


def build():
    """Compile bvh_builder.cpp unless this source and these flags are built
    already; returns the library's path."""
    out = _out_path()
    t0 = time.perf_counter()
    built = not os.path.exists(out)
    if built:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the BVH builder for 2,048 "
                               "prims and more cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        r = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) on {SOURCE}:\n"
                               f"{r.stderr}")
        os.replace(tmp, out)
    build_info.update(path=out, built=built,
                      seconds=time.perf_counter() - t0)
    return out


def load():
    """The loaded builder library (building it on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.rtp_build_bvh.restype = ctypes.c_int
            lib.rtp_build_bvh.argtypes = [
                _F, _F, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_F),
                ctypes.POINTER(_I), _I, ctypes.POINTER(_I)]
            lib.rtp_free.restype = None
            lib.rtp_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def build_bvh_native(lo, hi, max_leaf_size=4):
    """Binned-SAH build over prim boxes [lo, hi] ((P, 3) each, P > 0);
    returns (bounds (M, 12) float32, children (M, 2) int32, prim_order (P,)
    int32)."""
    lib = load()
    lo = np.ascontiguousarray(lo, np.float32).reshape(-1, 3)
    hi = np.ascontiguousarray(hi, np.float32).reshape(-1, 3)
    n = len(lo)
    if n == 0 or hi.shape != lo.shape:
        raise ValueError(f"prim boxes of shapes {lo.shape} and {hi.shape}")
    out_bounds, out_children, out_order = _F(), _I(), _I()
    out_nnodes = ctypes.c_int32()
    rc = lib.rtp_build_bvh(
        lo.ctypes.data_as(_F), hi.ctypes.data_as(_F), n, int(max_leaf_size),
        ctypes.byref(out_bounds), ctypes.byref(out_children),
        ctypes.byref(out_nnodes), ctypes.byref(out_order))
    if rc != 0:
        raise MemoryError(f"rtp_build_bvh failed ({rc}) on {n} prims")
    try:
        nn = out_nnodes.value
        bounds = np.ctypeslib.as_array(out_bounds, (nn, 12)).copy()
        children = np.ctypeslib.as_array(out_children, (nn, 2)).copy()
        order = np.ctypeslib.as_array(out_order, (n,)).copy()
    finally:
        for p in (out_bounds, out_children, out_order):
            lib.rtp_free(p)
    return bounds, children, order
