"""World settings (JAX counterpart:
raytracingproject_tpu/models/background.py).

The background shader is evaluated for rays that leave the scene
(ops/shade.py eval_background); None means black. Transparent film is not
ported and raises in the host compile.
"""

from __future__ import annotations

from raytracingproject_tpu_torch.models.node import Node, SocketType as S
from raytracingproject_tpu_torch.models.object import PATH_RAY_ALL_VISIBILITY


class Background(Node):
    SOCKETS = [
        S("ao_factor", S.FLOAT, 0.0),
        S("ao_distance", S.FLOAT, 1e10),
        S("use_shader", S.BOOLEAN, True),
        S("use_ao", S.BOOLEAN, False),
        S("visibility", S.UINT, PATH_RAY_ALL_VISIBILITY),
        S("transparent", S.BOOLEAN, False),
        S("transparent_glass", S.BOOLEAN, False),
        S("transparent_roughness_threshold", S.FLOAT, 0.0),
        S("volume_step_size", S.FLOAT, 0.1),
    ]

    def __init__(self, name="background", shader=None, **kwargs):
        super().__init__(name, **kwargs)
        self.shader = shader  # Shader evaluated for missed rays
