"""K6's kernel (ops/onehot2_walk.py, csrc/onehot2_walk.cu) against its
plain torch mirrors of the visit order, on the card: on the big_instanced
two-level tables (instance rows; 65,536 random rays from inside the
scene's bounds) and on a synthetic two-level table at the caps (512
superclusters of 16 clusters of 38 triangles, ops/onehot2_walk.py
grid_tables2; 8,192 random rays around it), closest and any hit:

- every output equal to onehot2_scan_order's (the first design's visit
  order) on every lane, exact-t ties included, and t, u, v equal to the
  plain walk's (ops/cluster_intersect.py intersect_clusters) to the bit
  on every lane whose prim and object agree with it;
- the counting variant (counts=True): outputs equal to the plain
  launch's, (N, 8) int32 counts equal to onehot2_queue_order's on every
  lane.

Marked `cuda`: skipped where no card is present (decided in the fixture,
never at import). On the GPU machine:
    python -m pytest tests/test_torch_onehot2_cuda.py -q --noconftest
(--noconftest: tests/conftest.py imports jax, which that machine lacks)
"""

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.app import examples
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import onehot2_walk as k6

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def tables():
    """{name: (sc_bounds, cbounds, ctable, cluster_tris, gmax, ray box)}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    s = examples.instanced_scene(64, 64, spp=2, grid=8)
    s.device_update()
    kg = s.make_kernel_globals("cuda")
    ds = kg["dscene"]
    scb, cb, ctab = k6.grid_tables2(512, 16, 38, np.random.default_rng(23),
                                    "cuda")
    return {"big_instanced": (ds["sc_bounds"], ds["cluster_bounds"],
                              ds["cluster_table"], int(kg["cluster_tris"]),
                              int(kg["sc_gmax"]), (-20.0, 20.0), 65536),
            "cap": (scb, cb, ctab, 38, 16, (-200.0, 1000.0), 8192)}


def _rays(seed, lo, hi, n):
    r = np.random.default_rng(seed)
    o = r.uniform((lo,) * 3, (hi,) * 3, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax_any = np.where(r.uniform(size=n) < 0.5,
                        r.uniform(1.0, hi - lo, n), 1e30).astype(np.float32)
    return [torch.tensor(a, device="cuda") for a in (o, d, tmax_any)]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("table", ["big_instanced", "cap"])
def test_onehot2_walk_kernel_in_scan_order(tables, table, any_hit):
    *tabs, (lo, hi), n = tables[table]
    o, d, tmax_any = _rays(24 + any_hit, lo, hi, n)
    tmin = torch.full((n,), 1e-4, device="cuda")
    tmax = tmax_any if any_hit else torch.full((n,), 1e30, device="cuda")
    args = (*tabs, o, d, tmin, tmax,
            torch.ones(n, dtype=torch.int32, device="cuda"))
    kw = {"shadow_any_hit": any_hit, "has_instances": True}
    before = k6.launches
    got = k6.intersect_clusters2_onehot(*args, **kw)
    got_c, cnt = k6.intersect_clusters2_onehot(*args, counts=True, **kw)
    scan, _, _ = k6.onehot2_scan_order(*args, **kw)
    _, qcnt, _ = k6.onehot2_queue_order(*args, **kw)
    ref = ci.intersect_clusters(*args[1:4], *args[5:], **kw)
    torch.cuda.synchronize()
    assert k6.launches == before + 2
    assert (ref["prim"] >= 0).float().mean().item() > 0.05
    for k in scan:
        assert torch.equal(got[k], scan[k]), k
        assert torch.equal(got_c[k], got[k]), k
    assert cnt.shape == (n, 8) and cnt.dtype == torch.int32
    assert torch.equal(cnt, qcnt)
    assert torch.equal(got["prim"] >= 0, ref["prim"] >= 0)
    if not any_hit:
        same = (got["prim"] == ref["prim"]) & (got["object"] == ref["object"])
        assert (~same).float().mean().item() <= 1e-4
        for k in ("t", "u", "v"):
            assert torch.equal(got[k][same], ref[k][same]), k
