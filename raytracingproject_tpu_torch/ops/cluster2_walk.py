"""K5: the two-level tile-shared cluster walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_cluster.py intersect_clusters2_pallas).

`intersect_clusters2_walk` takes the supercluster table sc_bounds (SC, 8)
and its group size gmax beside the cluster tables and has the contract of
the plain walk ops/cluster_intersect.py `intersect_clusters` over all C
clusters, which is its plain version (the second level only prunes). A
CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel csrc/cluster2_walk.cu or raises. The kernel walks a
warp of 32 rays together, one supercluster and then one cluster per step,
so prim and object may differ from the plain version's at exact-t ties
between clusters; hit masks, t, u and v agree. Instance rows (w2o in the
row) are tested in object space. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci

launches = 0

MAX_SUPERCLUSTERS = 512        # the JAX package's two-level cap
TILE = 32
SMEM_BYTES = 227 * 1024        # shared memory a block may have (H100)


def smem_per_warp(sc, gmax, w):
    """Shared-memory bytes one warp needs: the (SC, 32) supercluster and
    (gmax, 32) group entry tables and one row."""
    return ((sc + gmax) * TILE + w) * 4


def intersect_clusters2_walk(sc_bounds, cbounds, ctable, cluster_tris, gmax,
                             o, d, tmin, tmax, visibility,
                             shadow_any_hit=False, has_instances=False,
                             has_motion=False):
    """Closest hit (or any hit) over the two-level cluster tables;
    returns dict t, u, v (f32) and prim, object (int32), (N,) each."""
    global launches
    if has_motion:
        raise NotImplementedError("motion cluster rows are not ported")
    if o.device.type == "cpu":
        return ci.intersect_clusters(cbounds, ctable, cluster_tris, o, d,
                                     tmin, tmax, visibility,
                                     shadow_any_hit=shadow_any_hit,
                                     has_instances=has_instances)
    kernels.require(int(gmax) > 0, "gmax must be positive")
    kernels.require(
        smem_per_warp(sc_bounds.shape[0], int(gmax), ctable.shape[1])
        <= SMEM_BYTES,
        f"SC {sc_bounds.shape[0]} + gmax {gmax} entry tables do not fit one "
        "warp's shared memory")
    out = launch_two_level("rt_cluster2_walk", sc_bounds, cbounds, ctable,
                           cluster_tris, gmax, o, d, tmin, tmax, visibility,
                           shadow_any_hit, has_instances)
    launches += 1
    return out


def launch_two_level(entry, sc_bounds, cbounds, ctable, cluster_tris, gmax,
                     o, d, tmin, tmax, visibility, shadow_any_hit,
                     has_instances):
    """Check the arguments the two-level kernels share (K5's
    rt_cluster2_walk, K6's rt_onehot2_walk: one argument list), allocate
    the outputs and launch C entry point `entry`; returns the hit dict."""
    n, sc, c, w = o.shape[0], sc_bounds.shape[0], cbounds.shape[0], \
        ctable.shape[1]
    req = kernels.require
    for name, x in (("sc_bounds", sc_bounds), ("cbounds", cbounds),
                    ("ctable", ctable), ("o", o), ("d", d), ("tmin", tmin),
                    ("tmax", tmax), ("visibility", visibility)):
        req(x.device.type == "cuda", f"{name} must be a CUDA tensor")
        req(x.is_contiguous(), f"{name} must be contiguous")
        req(x.dtype == (torch.int32 if name == "visibility"
                        else torch.float32), f"{name}: wrong dtype {x.dtype}")
    req(0 < sc <= MAX_SUPERCLUSTERS,
        f"{sc} superclusters: the kernel takes 1..{MAX_SUPERCLUSTERS}")
    req(sc_bounds.shape == (sc, 8), "sc_bounds must be (SC, 8)")
    req(c > 0 and cbounds.shape == (c, 6), "cbounds must be (C, 6)")
    req(ctable.shape[0] == c and w == ci.row_width(cluster_tris),
        "ctable must be (C, row_width(cluster_tris))")
    req(o.shape == (n, 3) and d.shape == (n, 3), "o, d must be (N, 3)")
    for x in (tmin, tmax, visibility):
        req(x.shape == (n,), "tmin, tmax, visibility must be (N,)")
    dev = o.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    obj = torch.empty(n, dtype=torch.int32, device=dev)
    rc = getattr(kernels.load(), entry)(
        sc_bounds.data_ptr(), cbounds.data_ptr(), ctable.data_ptr(), sc, c,
        w, int(cluster_tris), int(gmax), o.data_ptr(), d.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), visibility.data_ptr(), n,
        int(bool(shadow_any_hit)), int(bool(has_instances)), t.data_ptr(),
        prim.data_ptr(), u.data_ptr(), v.data_ptr(), obj.data_ptr(),
        kernels.current_stream())
    kernels.check_rc(entry, rc)
    return {"t": t, "prim": prim, "u": u, "v": v, "object": obj}
