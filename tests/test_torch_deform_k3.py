"""K3's motion-row contract, both forms in one call: the port's plain
occlusion walk (ops/cluster_intersect.py occlusion_clusters with
has_motion, K3's plain version) against the JAX package's K3
(ops/pallas_cluster.py occlusion_clusters_pallas in interpret mode with
has_motion) on glossy_deform's table (179 x 15, motion rows) with seeded
boundary flags: even lanes the surface form (an empty closest window),
odd lanes the dual form, on the 512 seeded rays of
tests/test_torch_deform.py at their seeded times. blocked agrees on all
but DIFF_FRAC of the lanes and the minima within CONTRACTED_RTOL
(XLA:CPU contracts the time lerp's multiply-add); the port's minima are
the plain closest motion walk's over the prims of each kind. A file of
its own: an interpret-mode compile of the JAX kernel takes about 20 s."""

import jax.numpy as jnp
import numpy as np
import torch

from raytracingproject_tpu.ops import pallas_cluster as pcl
from raytracingproject_tpu_torch.models import object as ob
from raytracingproject_tpu_torch.ops import cluster_intersect as tci
from tests.test_torch_deform import (
    CONTRACTED_RTOL, DIFF_FRAC, port_kg, rays)


def test_plain_motion_occlusion_vs_jax_k3():
    kg = port_kg("glossy")
    ds = kg["dscene"]
    r = rays("glossy")
    n = len(r["o"])
    ct = kg["cluster_tris"]
    bnd = (np.random.default_rng(3).uniform(size=(ds["cluster_table"]
                                                  .shape[0], ct)) < 0.3
           ).astype(np.float32)
    tmc = np.where(np.arange(n) % 2 == 0, r["tmin"], r["tmax_any"]) \
        .astype(np.float32)
    cb, ctab = ds["cluster_bounds"].numpy(), ds["cluster_table"].numpy()
    ref = pcl.occlusion_clusters_pallas(
        jnp.asarray(cb), jnp.asarray(ctab), jnp.asarray(bnd), ct,
        jnp.asarray(r["o"]), jnp.asarray(r["d"]), jnp.asarray(r["tmin"]),
        tmax_closest=jnp.asarray(tmc), tmax_any=jnp.asarray(r["tmax_any"]),
        vis_closest=int(ob.PATH_RAY_CAMERA), vis_any=int(ob.PATH_RAY_SHADOW),
        time=jnp.asarray(r["time"]), has_motion=True, interpret=True)
    t = torch.from_numpy
    got = tci.occlusion_clusters(
        ds["cluster_bounds"], ds["cluster_table"], t(bnd), ct, t(r["o"]),
        t(r["d"]), t(r["tmin"]), t(tmc), t(r["tmax_any"]),
        ob.PATH_RAY_CAMERA, ob.PATH_RAY_SHADOW, time=t(r["time"]),
        has_motion=True)
    jb, jo, jblk = (np.asarray(x) for x in ref)
    gb, go, gblk = (x.numpy() for x in got)
    assert 0.2 < gblk.mean() < 0.99
    assert (gblk != jblk).mean() <= DIFF_FRAC
    assert (gb < 1e29).any() and (go < 1e29).any()
    np.testing.assert_allclose(gb, jb, rtol=CONTRACTED_RTOL)
    np.testing.assert_allclose(go, jo, rtol=CONTRACTED_RTOL)
