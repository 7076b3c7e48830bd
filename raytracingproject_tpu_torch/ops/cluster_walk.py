"""K2: the per-lane cluster walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_onehot.py intersect_clusters_onehot).

`intersect_clusters_walk` has the contract of the plain walk
ops/cluster_intersect.py `intersect_clusters`, which is its plain
version. A CPU tensor takes the plain version; a CUDA tensor launches
the hand-written kernel csrc/cluster_walk.cu or raises. `launches`
counts kernel launches. With has_instances each row's first 12 floats
are its instance's world-to-object matrix, and a lane's ray is taken to
the row's object space before the row's triangle tests. With has_motion
the rows are motion rows (ops/cluster_intersect.py) and each lane tests
the triangles at its time (time (N,) f32; zeros when None, as the JAX
walks take it); motion rows never carry instances, and the two together
raise.

The packed visit key keeps a 9-bit cluster id, so the kernel takes at
most MAX_CLUSTERS clusters; `fits(C, W)` states it together with the JAX
package's other condition for packing its one-hot tables (their VMEM
footprint at row width W), and the integrator sends a table that does
not fit to K4 (ops/tile_walk.py), as the JAX package does when its
one-hot tables decline to pack. With counts=True the
counting variant runs and the call also returns (N, 2) int32 counts per
lane: the cluster rows it tested and the cluster boxes it tested (CUDA
tensors only).
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci

launches = 0

MAX_CLUSTERS = 512   # 9-bit cluster id in the packed visit key
# the JAX package's VMEM budget for its one-hot tables
# (ops/pallas_onehot.py VMEM_BUDGET, pack_onehot_tables)
VMEM_BUDGET = 14 * 2 ** 20


def fits(c, w=0):
    """Whether a single-level table of c clusters, rows w floats wide,
    is within K2's (and K7's) capacity: the JAX package packs its one-hot
    tables only for c <= 512 and while (c_pad x 13 + w_pad x 10 + 1024) x
    1024 bytes fit its VMEM budget (c padded to 128, at least 128; w to
    16)."""
    c = int(c)
    if not 0 < c <= MAX_CLUSTERS:
        return False
    c_pad = max(128, -(-c // 128) * 128)
    w_pad = -(-int(w) // 16) * 16
    return (c_pad * 13 + w_pad * 10 + 1024) * 1024 <= VMEM_BUDGET


def no_motion_instances(has_instances, has_motion):
    """Motion rows never carry instances (the JAX package packs no
    cluster table for moving instances)."""
    if has_instances and has_motion:
        raise NotImplementedError(
            "motion rows with instance rows: the JAX package packs no such "
            "table")


def check_walk_args(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                    visibility, max_clusters=MAX_CLUSTERS, time=None):
    """Raise NotImplementedError past the kernel's capacity of
    max_clusters clusters, then ValueError unless the arguments are what
    the closest-hit walk kernels (K2, K4, K7) take (with time, motion
    rows and the lanes' times); returns (N, C, W)."""
    n, c, w = o.shape[0], cbounds.shape[0], ctable.shape[1]
    kernels.unsupported(
        c <= max_clusters, f"{c} clusters: the kernel takes at most "
        f"{max_clusters}")
    req = kernels.require
    lanes = (("cbounds", cbounds), ("ctable", ctable), ("o", o), ("d", d),
             ("tmin", tmin), ("tmax", tmax), ("visibility", visibility))
    if time is not None:
        lanes += (("time", time),)
    for name, x in lanes:
        req(x.device.type == "cuda", f"{name} must be a CUDA tensor")
        req(x.is_contiguous(), f"{name} must be contiguous")
        req(x.dtype == (torch.int32 if name == "visibility"
                        else torch.float32), f"{name}: wrong dtype {x.dtype}")
    req(c > 0, "the walk needs at least one cluster")
    req(cbounds.shape == (c, 6), "cbounds must be (C, 6)")
    req(ctable.shape[0] == c
        and w == ci.row_width(cluster_tris, time is not None),
        "ctable must be (C, row_width(cluster_tris, motion))")
    req(o.shape == (n, 3) and d.shape == (n, 3), "o, d must be (N, 3)")
    for x in (tmin, tmax, visibility) + ((time,) if time is not None
                                         else ()):
        req(x.shape == (n,), "tmin, tmax, visibility, time must be (N,)")
    return n, c, w


def intersect_clusters_walk(cbounds, ctable, cluster_tris, o, d, tmin,
                            tmax, visibility, shadow_any_hit=False,
                            has_instances=False, time=None,
                            has_motion=False, counts=False):
    """Closest hit (or any hit) over the cluster tables; returns dict
    t, u, v (f32) and prim, object (int32), (N,) each; with counts=True
    (hit dict, (N, 2) int32 rows and boxes tested per lane)."""
    global launches
    no_motion_instances(has_instances, has_motion)
    if o.device.type == "cpu":
        if counts:
            raise NotImplementedError("visit counts come from the kernel")
        return ci.intersect_clusters(cbounds, ctable, cluster_tris, o, d,
                                     tmin, tmax, visibility,
                                     shadow_any_hit=shadow_any_hit,
                                     has_instances=bool(has_instances),
                                     time=time, has_motion=bool(has_motion))
    time = ci.lane_time(time, o.shape[0], has_motion, o.device)
    n, c, w = check_walk_args(cbounds, ctable, cluster_tris, o, d, tmin,
                              tmax, visibility, time=time)
    dev = o.device
    cnt = torch.empty((n, 2), dtype=torch.int32, device=dev) \
        if counts else None
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    obj = torch.empty(n, dtype=torch.int32, device=dev)
    rc = kernels.load().rt_cluster_walk(
        cbounds.data_ptr(), ctable.data_ptr(), c, w, int(cluster_tris),
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        visibility.data_ptr(), n, int(bool(shadow_any_hit)),
        int(bool(has_instances)), int(time is not None),
        time.data_ptr() if time is not None else None, t.data_ptr(),
        prim.data_ptr(), u.data_ptr(),
        v.data_ptr(), obj.data_ptr(), cnt.data_ptr() if counts else None,
        kernels.current_stream())
    kernels.check_rc("cluster_walk", rc)
    launches += 1
    hit = {"t": t, "prim": prim, "u": u, "v": v, "object": obj}
    return (hit, cnt) if counts else hit
