"""K7: the union walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_onehot.py intersect_clusters_onehot_dual).

`intersect_clusters_dual_walk` has the contract of
ops/cluster_intersect.py `intersect_clusters_dual`, which is its plain
version: per lane the closest hit of one ray and the any-hit answer of
another, over one pass through the single-level cluster table. A CPU
tensor takes the plain version; a CUDA tensor launches the hand-written
kernel csrc/dual_walk.cu or raises. `launches` counts kernel launches.
With has_instances both rays are taken to a row's object space by the
row's world-to-object matrix before its triangle tests; motion rows
raise.
With counts=True the counting variant runs and the call also returns
(N, 4) int32 counts per lane: the cluster rows it read, the rows read once
for both rays, the passes over the boxes and the boxes tested (CUDA
tensors only).
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk

launches = 0


def intersect_clusters_dual_walk(cbounds, ctable, cluster_tris, o_c, d_c,
                                 tmin_c, tmax_c, vis_c, o_a, d_a, tmin_a,
                                 tmax_a, vis_a, has_instances=False,
                                 has_motion=False, time=None, counts=False):
    """Closest hit of ray c and any hit of ray a; returns (dict t, u, v
    (f32) and prim, object (int32), blocked (bool)), (N,) each; with
    counts=True also the (N, 4) int32 counts. An empty window (tmax <
    tmin) disables that ray of the lane."""
    global launches
    if has_motion:
        raise NotImplementedError(
            "motion rows in K7 are not ported (time is read only with them)")
    kernels.unsupported(
        cbounds.shape[0] <= cluster_walk.MAX_CLUSTERS,
        f"{cbounds.shape[0]} clusters: the union walk takes at most "
        f"{cluster_walk.MAX_CLUSTERS}")
    if o_c.device.type == "cpu":
        if counts:
            raise NotImplementedError("visit counts come from the kernel")
        return ci.intersect_clusters_dual(
            cbounds, ctable, cluster_tris, o_c, d_c, tmin_c, tmax_c, vis_c,
            o_a, d_a, tmin_a, tmax_a, vis_a,
            has_instances=bool(has_instances))
    n, c, w = cluster_walk.check_walk_args(
        cbounds, ctable, cluster_tris, o_c, d_c, tmin_c, tmax_c, vis_c)
    cluster_walk.check_walk_args(
        cbounds, ctable, cluster_tris, o_a, d_a, tmin_a, tmax_a, vis_a)
    kernels.require(o_a.shape[0] == n, "both rays must have N lanes")
    dev = o_c.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    obj = torch.empty(n, dtype=torch.int32, device=dev)
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    cnt = torch.empty((n, 4), dtype=torch.int32, device=dev) \
        if counts else None
    rc = kernels.load().rt_dual_walk(
        cbounds.data_ptr(), ctable.data_ptr(), c, w, int(cluster_tris),
        o_c.data_ptr(), d_c.data_ptr(), tmin_c.data_ptr(), tmax_c.data_ptr(),
        vis_c.data_ptr(), o_a.data_ptr(), d_a.data_ptr(), tmin_a.data_ptr(),
        tmax_a.data_ptr(), vis_a.data_ptr(), n, int(bool(has_instances)),
        t.data_ptr(),
        prim.data_ptr(), u.data_ptr(), v.data_ptr(), obj.data_ptr(),
        blocked.data_ptr(), cnt.data_ptr() if counts else None,
        kernels.current_stream())
    kernels.check_rc("dual_walk", rc)
    launches += 1
    hit = {"t": t, "prim": prim, "u": u, "v": v, "object": obj}
    return (hit, blocked, cnt) if counts else (hit, blocked)
