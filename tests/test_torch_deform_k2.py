"""K2's motion-row contract, closest hit: the port's plain walk
(ops/cluster_intersect.py intersect_clusters with has_motion, K2's plain
version) against the JAX package's K2 (ops/pallas_onehot.py
intersect_clusters_onehot in interpret mode with has_motion, fed the
one-hot tables its host compile packs) on glossy_deform's single-level
table (179 clusters x 15 triangles, motion rows), on the 512 seeded rays
of tests/test_torch_deform.py at their seeded times. Held by
compare_motion (XLA:CPU contracts the time lerp's multiply-add). A file
of its own: an interpret-mode compile of the JAX kernel takes 20-40 s."""

import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.ops import pallas_onehot as po
from tests.test_torch_deform import (
    compare_motion, jax_kg, port_kg, port_walk, rays)


def test_plain_motion_walk_vs_jax_k2():
    jkg = jax_kg("glossy")
    jds = jkg["dscene"]
    r = rays("glossy")
    ref = po.intersect_clusters_onehot(
        jds["oh_cbounds"], jds["oh_table_hi"], jds["oh_table_mid"],
        jds["oh_table_lo"],
        int(jkg.get("oh_cluster_tris", 0) or jkg["cluster_tris"]),
        jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["tmin"]),
        jnp.asarray(r["tmax"]), jnp.asarray(r["vis"].astype(np.uint32)),
        time=jnp.asarray(r["time"]), has_motion=True, interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    kg = port_kg("glossy")
    compare_motion(kg, ref, port_walk(kg, r), r)
