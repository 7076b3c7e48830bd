"""K6's motion-row contract, closest hit: the port's plain walk
(ops/cluster_intersect.py intersect_clusters with has_motion, K6's plain
version) against the JAX package's K6 (ops/pallas_onehot.py
intersect_clusters2_onehot in interpret mode with has_motion, fed the
oh2_* group tables its host compile packs for this scene) on
glossy_deform_big's two-level motion tables (936 clusters x 64 in 25
superclusters), on the 256 seeded rays of
tests/test_torch_deform_two_level.py at their seeded times. Held by
tests/test_torch_deform.py compare_motion (XLA:CPU contracts the time
lerp's multiply-add). A file of its own: the interpret-mode compile of
the JAX kernel at 64 triangles a row takes about a minute."""

import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.ops import pallas_onehot as po
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from tests.test_torch_deform import compare_motion
from tests.test_torch_deform_two_level import (
    jax_kg, jax_lanes, lanes, port_kg, rays, _t)


def test_plain_motion_walk_vs_jax_k6():
    jkg, kg, r = jax_kg(), port_kg(), rays()
    jds, ds = jkg["dscene"], kg["dscene"]
    ref = po.intersect_clusters2_onehot(
        *(jnp.asarray(jds[k]) for k in ("oh2_scb", "oh2_gcb", "oh2_hi",
                                        "oh2_mid", "oh2_lo")),
        int(jkg.get("oh2_cluster_tris", 0) or jkg["cluster_tris"]),
        *jax_lanes(r), time=jnp.asarray(r["time"]), has_motion=True,
        interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tci.intersect_clusters(ds["cluster_bounds"], ds["cluster_table"],
                                 kg["cluster_tris"], *lanes(r),
                                 time=_t(r["time"]), has_motion=True)
    compare_motion(kg, ref, {k: v.numpy() for k, v in got.items()}, r)
