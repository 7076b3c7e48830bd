"""Lamps (JAX counterpart: raytracingproject_tpu/models/light.py).

Light types point, distant, background, area and spot, with the JAX
package's sockets and total_power (the weight of a lamp in the flat light
distribution). The host compile (models/scene.py) packs every type into
the lamp table; ops/light.py samples the distant type, and a scene whose
distribution holds another lamp type raises there.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.models.node import Node, SocketType as S

LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_BACKGROUND = 2
LIGHT_AREA = 3
LIGHT_SPOT = 4


class Light(Node):
    SOCKETS = [
        S("light_type", S.ENUM, "point",
          {"point": LIGHT_POINT, "distant": LIGHT_DISTANT,
           "background": LIGHT_BACKGROUND, "area": LIGHT_AREA,
           "spot": LIGHT_SPOT}),
        S("strength", S.COLOR, (1.0, 1.0, 1.0)),
        S("co", S.POINT, (0.0, 0.0, 0.0)),
        # point/spot
        S("size", S.FLOAT, 0.0),
        # distant
        S("dir", S.VECTOR, (0.0, 0.0, -1.0)),
        S("angle", S.FLOAT, 0.0),
        # area
        S("axisu", S.VECTOR, (1.0, 0.0, 0.0)),
        S("sizeu", S.FLOAT, 1.0),
        S("axisv", S.VECTOR, (0.0, 1.0, 0.0)),
        S("sizev", S.FLOAT, 1.0),
        S("round", S.BOOLEAN, False),
        S("spread", S.FLOAT, np.pi),
        # spot
        S("spot_angle", S.FLOAT, np.pi / 4.0),
        S("spot_smooth", S.FLOAT, 0.0),
        # portal: guides background sampling, emits nothing
        S("is_portal", S.BOOLEAN, False),
        # IES photometric profile (raw LM-63 text; empty = none)
        S("ies", S.STRING, ""),
        S("cast_shadow", S.BOOLEAN, True),
        S("use_mis", S.BOOLEAN, True),
        S("use_camera", S.BOOLEAN, True),
        S("use_diffuse", S.BOOLEAN, True),
        S("use_glossy", S.BOOLEAN, True),
        S("use_transmission", S.BOOLEAN, True),
        S("use_scatter", S.BOOLEAN, True),
        S("max_bounces", S.INT, 1024),
        S("map_resolution", S.INT, 0),
        S("samples", S.INT, 1),
    ]

    def __init__(self, name="light", shader=None, **kwargs):
        super().__init__(name, **kwargs)
        self.shader = shader  # optional emission Shader; else `strength`

    def total_power(self):
        """Approximate emitted power, the lamp's weight in the light
        distribution."""
        strength = np.asarray(self.strength, np.float32)
        lum = float(0.2126 * strength[0] + 0.7152 * strength[1]
                    + 0.0722 * strength[2])
        t = self.get_enum_int("light_type")
        if t == LIGHT_AREA:
            area = float(self.sizeu * self.sizev) * float(
                np.linalg.norm(np.cross(self.axisu, self.axisv)))
            return max(lum * area, 1e-12)
        if t == LIGHT_POINT or t == LIGHT_SPOT:
            return max(lum * 4.0 * np.pi, 1e-12)
        return max(lum, 1e-12)
