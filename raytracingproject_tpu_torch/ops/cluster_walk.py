"""K2: the per-lane cluster walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_onehot.py intersect_clusters_onehot).

`intersect_clusters_walk` has the contract of the plain walk
ops/cluster_intersect.py `intersect_clusters`, which is its plain
version. A CPU tensor takes the plain version; a CUDA tensor launches
the hand-written kernel csrc/cluster_walk.cu or raises. `launches`
counts kernel launches.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci

launches = 0

MAX_CLUSTERS = 512   # 9-bit cluster id in the packed visit key


def check_walk_args(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                    visibility):
    """Raise ValueError unless the arguments are what the closest-hit
    walk kernels (K2, K4) take; returns (N, C, W)."""
    n, c, w = o.shape[0], cbounds.shape[0], ctable.shape[1]
    req = kernels.require
    for name, x in (("cbounds", cbounds), ("ctable", ctable), ("o", o),
                    ("d", d), ("tmin", tmin), ("tmax", tmax),
                    ("visibility", visibility)):
        req(x.device.type == "cuda", f"{name} must be a CUDA tensor")
        req(x.is_contiguous(), f"{name} must be contiguous")
        req(x.dtype == (torch.int32 if name == "visibility"
                        else torch.float32), f"{name}: wrong dtype {x.dtype}")
    req(0 < c <= MAX_CLUSTERS, f"{c} clusters: the kernel takes 1..512")
    req(cbounds.shape == (c, 6), "cbounds must be (C, 6)")
    req(ctable.shape[0] == c and w == ci.row_width(cluster_tris),
        "ctable must be (C, row_width(cluster_tris))")
    req(o.shape == (n, 3) and d.shape == (n, 3), "o, d must be (N, 3)")
    for x in (tmin, tmax, visibility):
        req(x.shape == (n,), "tmin, tmax, visibility must be (N,)")
    return n, c, w


def intersect_clusters_walk(cbounds, ctable, cluster_tris, o, d, tmin,
                            tmax, visibility, shadow_any_hit=False,
                            has_instances=False, has_motion=False):
    """Closest hit (or any hit) over the cluster tables; returns dict
    t, u, v (f32) and prim, object (int32), (N,) each."""
    global launches
    if has_instances or has_motion:
        raise NotImplementedError(
            "instance and motion cluster rows are not ported")
    if o.device.type == "cpu":
        return ci.intersect_clusters(cbounds, ctable, cluster_tris, o, d,
                                     tmin, tmax, visibility,
                                     shadow_any_hit=shadow_any_hit)
    n, c, w = check_walk_args(cbounds, ctable, cluster_tris, o, d, tmin,
                              tmax, visibility)
    dev = o.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    obj = torch.empty(n, dtype=torch.int32, device=dev)
    rc = kernels.load().rt_cluster_walk(
        cbounds.data_ptr(), ctable.data_ptr(), c, w, int(cluster_tris),
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        visibility.data_ptr(), n, int(bool(shadow_any_hit)),
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        obj.data_ptr(), kernels.current_stream())
    kernels.check_rc("cluster_walk", rc)
    launches += 1
    return {"t": t, "prim": prim, "u": u, "v": v, "object": obj}
