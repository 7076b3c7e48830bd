"""K3: the occlusion walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_cluster.py occlusion_clusters_pallas).

`occlusion_clusters_walk` has the contract of the plain walk
ops/cluster_intersect.py `occlusion_clusters`, which is its plain
version: returns (t_boundary, t_other, blocked). A CPU tensor takes the
plain version; a CUDA tensor launches the hand-written kernel
csrc/occlusion_walk.cu or raises. `launches` counts kernel launches.
With has_instances each lane's ray is taken to a row's object space by
the row's world-to-object matrix before the row's triangle tests; with
has_motion (motion rows) each lane tests the row's triangles lerped to
its time (time (N,) f32, zeros when None); the two together raise.

The kernel keeps no visit queue, so it takes single-level tables up to
the JAX package's single-level cap, MAX_CLUSTERS (640), as its TPU
kernel does; `smem_bytes` is what a block of it needs. With counts=True
the counting variant runs and the call also returns (N, 3) int32 counts
per lane: the cluster rows it tested, the cluster boxes it tested and
the rows its warp staged (CUDA tensors only).
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk as cw

launches = 0

MAX_CLUSTERS = 640   # the JAX package's single-level cap
WARPS = 4            # warps per block (csrc/occlusion_walk.cu)
SMEM_BYTES = 48 * 1024   # a block's shared memory without an opt-in


def smem_bytes(c, ct, motion=False):
    """Shared-memory bytes of one block: the C cluster bounds and, per
    warp, one staged row of 12 floats a triangle (21 for motion rows),
    its 32 rays (17 floats each) and 3 x 32 words of results."""
    return (c * 6 + WARPS * ((21 if motion else 12) * ct + 32 * 17
                             + 3 * 32)) * 4


def occlusion_clusters_walk(cbounds, ctable, cboundary, cluster_tris, o, d,
                            tmin, tmax_closest, tmax_any, vis_closest,
                            vis_any, has_instances=False, time=None,
                            has_motion=False, counts=False):
    """(t_boundary, t_other, blocked), (N,) each; with counts=True
    ((t_boundary, t_other, blocked), (N, 3) int32 rows and boxes tested
    per lane and rows its warp staged)."""
    global launches
    cw.no_motion_instances(has_instances, has_motion)
    if o.device.type == "cpu":
        if counts:
            raise NotImplementedError("visit counts come from the kernel")
        return ci.occlusion_clusters(cbounds, ctable, cboundary,
                                     cluster_tris, o, d, tmin,
                                     tmax_closest, tmax_any, int(vis_closest),
                                     int(vis_any),
                                     has_instances=bool(has_instances),
                                     time=time, has_motion=bool(has_motion))
    n, c, w = o.shape[0], cbounds.shape[0], ctable.shape[1]
    ct = int(cluster_tris)
    time = ci.lane_time(time, n, has_motion, o.device)
    motion = time is not None
    kernels.unsupported(
        c <= MAX_CLUSTERS,
        f"{c} clusters: the kernel takes at most {MAX_CLUSTERS}")
    kernels.unsupported(
        smem_bytes(c, ct, motion) <= SMEM_BYTES,
        f"{c} clusters of {ct} triangles do not fit the kernel's 48 KB of "
        "shared memory")
    req = kernels.require
    for name, x in (("cbounds", cbounds), ("ctable", ctable),
                    ("cboundary", cboundary), ("o", o), ("d", d),
                    ("tmin", tmin), ("tmax_closest", tmax_closest),
                    ("tmax_any", tmax_any)) + ((("time", time),) if motion
                                              else ()):
        req(x.device.type == "cuda", f"{name} must be a CUDA tensor")
        req(x.is_contiguous(), f"{name} must be contiguous")
        req(x.dtype == torch.float32, f"{name}: wrong dtype {x.dtype}")
    req(c > 0, "the walk needs at least one cluster")
    req(cbounds.shape == (c, 6), "cbounds must be (C, 6)")
    req(ctable.shape[0] == c and w == ci.row_width(ct, motion),
        "ctable must be (C, row_width(cluster_tris, motion))")
    req(cboundary.shape == (c, ct), "cboundary must be (C, cluster_tris)")
    req(o.shape == (n, 3) and d.shape == (n, 3), "o, d must be (N, 3)")
    for x in (tmin, tmax_closest, tmax_any) + ((time,) if motion else ()):
        req(x.shape == (n,),
            "tmin, tmax_closest, tmax_any, time must be (N,)")
    dev = o.device
    t_b = torch.empty(n, dtype=torch.float32, device=dev)
    t_o = torch.empty(n, dtype=torch.float32, device=dev)
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    cnt = torch.empty((n, 3), dtype=torch.int32, device=dev) \
        if counts else None
    rc = kernels.load().rt_occlusion_walk(
        cbounds.data_ptr(), ctable.data_ptr(), cboundary.data_ptr(), c, w,
        ct, o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
        tmax_closest.data_ptr(), tmax_any.data_ptr(), n, int(vis_closest),
        int(vis_any), int(bool(has_instances)), int(motion),
        time.data_ptr() if motion else None, t_b.data_ptr(),
        t_o.data_ptr(), blocked.data_ptr(),
        cnt.data_ptr() if counts else None, kernels.current_stream())
    kernels.check_rc("occlusion_walk", rc)
    launches += 1
    return ((t_b, t_o, blocked), cnt) if counts else (t_b, t_o, blocked)
