"""K6: the two-level walk with a per-lane inner walk (JAX counterpart:
raytracingproject_tpu/ops/pallas_onehot.py intersect_clusters2_onehot).

`intersect_clusters2_onehot` takes K5's arguments (ops/cluster2_walk.py):
the supercluster table sc_bounds (SC, 8) and its group size gmax beside
the f32 cluster tables. The JAX package's bf16x3 group tables (oh2_*,
pack_onehot2_tables) are not built: they feed the TPU's matrix unit, and
the kernel reads the f32 rows directly. What is kept of that packing is
its capacity rule, gmax <= G_PAD (128 clusters per supercluster);
`fits(gmax)` states it, and the integrator falls back to K5 where it
fails, as the JAX package does when its packing declines.

The contract is the plain walk's, ops/cluster_intersect.py
`intersect_clusters` over all C clusters (the JAX package's own reference
for this kernel), which is the plain version. A CPU tensor takes the
plain version; a CUDA tensor launches the hand-written kernel
csrc/onehot2_walk.cu or raises. The outer level is shared by a warp of 32
rays and each lane walks a picked group's clusters in its own order, so
prim and object may differ from the plain version's at exact-t ties
between clusters; hit masks, t, u and v agree. Motion rows raise.
`launches` counts kernel launches.
"""

from __future__ import annotations

from raytracingproject_tpu_torch import kernels
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops.cluster2_walk import (
    SMEM_BYTES, TILE, launch_two_level)

launches = 0

G_PAD = 128   # clusters per supercluster the inner walk takes


def fits(gmax):
    """Whether two-level tables with groups of up to gmax clusters are
    within K6's capacity."""
    return 0 < int(gmax) <= G_PAD


def smem_per_warp(sc):
    """Shared-memory bytes one warp needs: the (SC, 32) supercluster
    entry table and one group's bounds."""
    return (sc * TILE + G_PAD * 6) * 4


def intersect_clusters2_onehot(sc_bounds, cbounds, ctable, cluster_tris, gmax,
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
    kernels.unsupported(
        fits(gmax), f"gmax {gmax}: the inner walk takes groups of 1..{G_PAD}")
    kernels.unsupported(
        smem_per_warp(sc_bounds.shape[0]) <= SMEM_BYTES,
        f"the SC {sc_bounds.shape[0]} entry table does not fit one warp's "
        "shared memory")
    out = launch_two_level("rt_onehot2_walk", sc_bounds, cbounds, ctable,
                           cluster_tris, gmax, o, d, tmin, tmax, visibility,
                           shadow_any_hit, has_instances)
    launches += 1
    return out
