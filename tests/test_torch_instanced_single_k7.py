"""K7's contract with instance rows: the port's plain union walk
(ops/cluster_intersect.py intersect_clusters_dual with has_instances,
K7's plain version: the closest walk on one ray, the any-hit walk on the
other) against the JAX package's K7 (ops/pallas_onehot.py
intersect_clusters_onehot_dual in interpret mode, tile=1024 as its own
tests run it) on instanced_scene(grid=5, nlat=15)'s table. The closest
rays are the 768 seeded rays of tests/test_torch_instanced_single.py;
each lane's any-hit ray starts 0.05 off its closest ray's origin, toward
the sun (a sun shadow ray, window unbounded) on half the lanes and toward
the centre of a seeded sphere (window ending at the centre) on the
other half, and an eighth of the lanes have an empty any-hit window
(tmax < tmin, which disables that ray). blocked is equal; the closest
hit is held as K2's (compare_closest)."""

import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.ops import pallas_onehot as po
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from tests.test_torch_instanced_single import (
    SUN, _t, compare_closest, jax_kg, port_kg, rays)

SCENE = "grid5_nlat15"


def test_plain_union_walk_vs_jax_k7():
    kg, jkg, r = port_kg(SCENE), jax_kg(SCENE), rays(SCENE)
    n = len(r["o"])
    g = np.random.default_rng(29)
    o_a = (r["o"] + 0.05 * SUN).astype(np.float32)
    # the sphere centres of instanced_scene(grid=5)
    cell = (g.integers(0, 5, (n, 2)) - 2.0) * 4.0
    to_c = np.concatenate([cell, np.ones((n, 1))], 1) - o_a
    dist = np.linalg.norm(to_c, axis=1)
    sun = g.uniform(size=n) < 0.5
    d_a = np.where(sun[:, None], SUN, to_c / dist[:, None]).astype(
        np.float32)
    tmin_a = np.full(n, 1e-5, np.float32)
    tmax_a = np.where(sun, 1e30, dist).astype(np.float32)
    tmax_a[g.uniform(size=n) < 0.125] = -1.0
    vis_a = np.full(n, ob.PATH_RAY_SHADOW, np.int32)
    jds = jkg["dscene"]
    hit, blk = po.intersect_clusters_onehot_dual(
        jds["oh_cbounds"], jds["oh_table_hi"], jds["oh_table_mid"],
        jds["oh_table_lo"],
        int(jkg.get("oh_cluster_tris", 0) or jkg["cluster_tris"]),
        jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["tmin"]),
        jnp.asarray(r["tmax"]), jnp.asarray(r["vis"].astype(np.uint32)),
        jnp.asarray(o_a), jnp.asarray(d_a), jnp.asarray(tmin_a),
        jnp.asarray(tmax_a), jnp.asarray(vis_a.astype(np.uint32)),
        has_instances=True, tile=1024, interpret=True)
    ref = {k: np.asarray(v) for k, v in hit.items()}
    ds = kg["dscene"]
    got, got_blk = tci.intersect_clusters_dual(
        ds["cluster_bounds"], ds["cluster_table"], kg["cluster_tris"],
        _t(r["o"]), _t(r["d"]), _t(r["tmin"]), _t(r["tmax"]), _t(r["vis"]),
        _t(o_a), _t(d_a), _t(tmin_a), _t(tmax_a), _t(vis_a),
        has_instances=True)
    got_blk = got_blk.numpy()
    np.testing.assert_array_equal(got_blk, np.asarray(blk))
    assert not got_blk[tmax_a < 0].any()
    assert 0.05 < got_blk.mean() < 0.95
    compare_closest(kg, ref, {k: v.numpy() for k, v in got.items()}, r)
