"""K2's contract with instance rows, any hit: the port's plain walk with
shadow_any_hit and has_instances against the JAX package's K2
(intersect_clusters_onehot in interpret mode) on instanced_scene(grid=5,
nlat=15)'s table, on the 768 seeded rays of
tests/test_torch_instanced_single.py with their any-hit windows: the hit
masks are equal (which hit a lane stops at is the walk's own). The
closest-hit mode is tests/test_torch_instanced_single_k2.py."""

from tests.test_torch_instanced_single import (
    compare_closest, port_closest, port_kg, rays)
from tests.test_torch_instanced_single_k2 import SCENE, jax_k2


def test_plain_walk_vs_jax_k2_any_hit():
    kg, r = port_kg(SCENE), rays(SCENE)
    compare_closest(kg, jax_k2(True), port_closest(kg, r, True), r, True)
