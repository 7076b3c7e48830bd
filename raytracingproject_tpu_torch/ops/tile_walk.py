"""K4: the tile-shared cluster walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_cluster.py intersect_clusters_pallas).

`intersect_clusters_tile` has the contract of the plain walk
ops/cluster_intersect.py `intersect_clusters`, which is its plain version
(K2 shares it). A CPU tensor takes the plain version; a CUDA tensor
launches the hand-written kernel csrc/tile_walk.cu or raises. The kernel
walks a warp of 32 rays together, one cluster per step, so prim and
object may differ from the plain version's at exact-t ties between
clusters; hit masks, t, u and v agree. `launches` counts kernel
launches.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import cluster_walk as cw

launches = 0


def intersect_clusters_tile(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                            visibility, shadow_any_hit=False,
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
    n, c, w = cw.check_walk_args(cbounds, ctable, cluster_tris, o, d, tmin,
                                 tmax, visibility)
    dev = o.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    obj = torch.empty(n, dtype=torch.int32, device=dev)
    rc = kernels.load().rt_tile_walk(
        cbounds.data_ptr(), ctable.data_ptr(), c, w, int(cluster_tris),
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        visibility.data_ptr(), n, int(bool(shadow_any_hit)),
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        obj.data_ptr(), kernels.current_stream())
    kernels.check_rc("tile_walk", rc)
    launches += 1
    return {"t": t, "prim": prim, "u": u, "v": v, "object": obj}
