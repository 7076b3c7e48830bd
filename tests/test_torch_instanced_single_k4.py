"""K4's contract with instance rows: the port's plain walk
(ops/cluster_intersect.py intersect_clusters with has_instances, the
plain version of K4 and K2) against the JAX package's K4
(ops/pallas_cluster.py intersect_clusters_pallas in interpret mode) on
instanced_scene(grid=6)'s single-level table (577 clusters x 38
triangles with instance rows), closest and any hit, on the 768 seeded
rays of tests/test_torch_instanced_single.py (random, camera, sun
shadow). The JAX kernel walks a tile of rays one cluster a step, the
plain walk each lane in its own entry order: hit masks are equal, prim
and object off exact-t ties, and t, u, v equal the JAX package's or the
numpy golden's bit for bit (compare_closest). A file of its own: each
interpret-mode compile of the JAX kernel takes about 20 s on an 8-core
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracingproject_tpu.ops import pallas_cluster as pcl
from tests.test_torch_instanced_single import (
    compare_closest, port_closest, port_kg, rays)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_vs_jax_k4(any_hit):
    kg = port_kg("grid6")
    r = rays("grid6")
    ds = kg["dscene"]
    tmax = r["tmax_any"] if any_hit else r["tmax"]
    ref = pcl.intersect_clusters_pallas(
        jnp.asarray(ds["cluster_bounds"].numpy()),
        jnp.asarray(ds["cluster_table"].numpy()), kg["cluster_tris"],
        jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["tmin"]),
        jnp.asarray(tmax), jnp.asarray(r["vis"].astype(np.uint32)),
        shadow_any_hit=any_hit, has_instances=True, interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    compare_closest(kg, ref, port_closest(kg, r, any_hit), r, any_hit)
