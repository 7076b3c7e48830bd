"""K4's motion-row contract: the port's plain walk
(ops/cluster_intersect.py intersect_clusters with has_motion, the plain
version of K4 and K2) against the JAX package's K4
(ops/pallas_cluster.py intersect_clusters_pallas in interpret mode with
has_motion) on glossy_deform's table (179 x 15, motion rows), closest
and any hit, on the 512 seeded rays of tests/test_torch_deform.py at
their seeded times. The JAX kernel walks a tile of rays one cluster a
step, the plain walk each lane in its own entry order; held by
compare_motion. A file of its own: each interpret-mode compile of the
JAX kernel takes about 20 s."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracingproject_tpu.ops import pallas_cluster as pcl
from tests.test_torch_deform import (
    compare_motion, port_kg, port_walk, rays)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_motion_walk_vs_jax_k4(any_hit):
    kg = port_kg("glossy")
    r = rays("glossy")
    ds = kg["dscene"]
    ref = pcl.intersect_clusters_pallas(
        jnp.asarray(ds["cluster_bounds"].numpy()),
        jnp.asarray(ds["cluster_table"].numpy()), kg["cluster_tris"],
        jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["tmin"]),
        jnp.asarray(r["tmax_any"] if any_hit else r["tmax"]),
        jnp.asarray(r["vis"].astype(np.uint32)), shadow_any_hit=any_hit,
        time=jnp.asarray(r["time"]), has_motion=True, interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    compare_motion(kg, ref, port_walk(kg, r, any_hit), r, any_hit)
