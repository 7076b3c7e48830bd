"""K2's contract with instance rows, closest hit: the port's plain walk
(ops/cluster_intersect.py intersect_clusters with has_instances, K2's
plain version) against the JAX package's K2 (ops/pallas_onehot.py
intersect_clusters_onehot in interpret mode, fed the one-hot tables its
host compile packs) on instanced_scene(grid=5, nlat=15)'s single-level
table (401 clusters x 48 triangles with instance rows), on the 768
seeded rays of tests/test_torch_instanced_single.py. Both walk each lane
in its own entry order: hit masks, prim and object are equal off
exact-t ties, and t, u, v equal the JAX package's or the numpy golden's
bit for bit (compare_closest). The any-hit mode is
tests/test_torch_instanced_single_k2_any.py: each interpret-mode compile
of the JAX kernel takes about 30 s on an 8-core CPU."""

import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.ops import pallas_onehot as po
from tests.test_torch_instanced_single import (
    compare_closest, jax_kg, port_closest, port_kg, rays)

SCENE = "grid5_nlat15"


def jax_k2(any_hit):
    """The JAX package's K2 on the scene's one-hot tables."""
    jkg = jax_kg(SCENE)
    jds = jkg["dscene"]
    r = rays(SCENE)
    tmax = r["tmax_any"] if any_hit else r["tmax"]
    ref = po.intersect_clusters_onehot(
        jds["oh_cbounds"], jds["oh_table_hi"], jds["oh_table_mid"],
        jds["oh_table_lo"],
        int(jkg.get("oh_cluster_tris", 0) or jkg["cluster_tris"]),
        jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["tmin"]),
        jnp.asarray(tmax), jnp.asarray(r["vis"].astype(np.uint32)),
        shadow_any_hit=any_hit, has_instances=True, interpret=True)
    return {k: np.asarray(v) for k, v in ref.items()}


def test_plain_walk_vs_jax_k2_closest():
    kg, r = port_kg(SCENE), rays(SCENE)
    compare_closest(kg, jax_k2(False), port_closest(kg, r), r)
