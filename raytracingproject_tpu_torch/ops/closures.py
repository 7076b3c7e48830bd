"""Fixed-slot closure union (JAX counterpart:
raytracingproject_tpu/ops/closures.py).

A shader evaluates to weighted closure slots, SoA over the wavefront.
The port carries the slots its node classes produce: emission, diffuse
(Lambert), glossy (GGX reflection), transparent (pass-through, which the
integrator fills for volume boundaries), and subsurface (random-walk SSS:
color, radius per channel, and the Burley-falloff flag). The JAX
package's other slots are always zero on the port's scenes, so dropping
them changes no result; a node that would fill one is not in the port's
registry and raises.

A volume shader evaluates to the volume closure union: extinction
sigma_t, scattering sigma_s, emission and the Henyey-Greenstein
anisotropy g.
"""

from __future__ import annotations

import torch

CLOSURE_VEC_KEYS = ("emission", "diffuse", "glossy", "transparent",
                    "subsurface", "subsurface_radius")
CLOSURE_SCALAR_KEYS = ("glossy_roughness", "subsurface_burley")


def empty_closures(batch_shape, device):
    c = {k: torch.zeros(batch_shape + (3,), device=device)
         for k in CLOSURE_VEC_KEYS}
    for k in CLOSURE_SCALAR_KEYS:
        c[k] = torch.zeros(batch_shape, device=device)
    return c


def empty_volume_closures(batch_shape, device):
    return {"sigma_t": torch.zeros(batch_shape + (3,), device=device),
            "sigma_s": torch.zeros(batch_shape + (3,), device=device),
            "v_emission": torch.zeros(batch_shape + (3,), device=device),
            "anisotropy": torch.zeros(batch_shape, device=device)}
