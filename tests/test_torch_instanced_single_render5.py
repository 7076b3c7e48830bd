"""instanced_scene(grid=5, nlat=15) end to end on the CPU: the port's
render_samples_regen at 16x16, 4 spp, in one chunk of 4, unfused
(closest hits through K2's plain version, shadow tests through K3's) and
in fused-NEE mode (both through K7's plain version), all with instance
rows, against the JAX package's render_samples_regen, under the gates of
tests/test_torch_instanced_single_render6.py. The fused render is held
to the JAX package's unfused image: its own fused render runs its union
walk in interpret mode (about 100 s at this size on an 8-core CPU), and
its tests (tests/test_fused_nee.py) hold its fused and unfused renders
equal to float tolerance."""

from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.ops import integrator as integ
from tests.test_torch_instanced_single import port_kg
from tests.test_torch_instanced_single_render6 import (
    assert_render_gates, jax_image, port_render)

SCENE = {"grid": 5, "nlat": 15}


def test_grid5_nlat15_render_matches_jax():
    kg = port_kg("grid5_nlat15")
    assert not integ._use_fused_nee(kg)
    assert_render_gates(port_render(kg), jax_image(**SCENE))


def test_grid5_nlat15_fused_render_matches_jax():
    kg = {**port_kg("grid5_nlat15"), **tex.FUSED_NEE}
    assert integ._use_fused_nee(kg)
    assert_render_gates(port_render(kg), jax_image(**SCENE))
