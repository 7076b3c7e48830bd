"""Integrator settings (JAX counterpart:
raytracingproject_tpu/models/integrator.py). `kernel_record` gives the
same `kint` dict as the JAX package (the volume knobs volume_max_steps,
volume_step_rate and max_volume_bounce included; volume_stack_depth goes
to the kernel globals, as in the JAX package); the integrator raises on
settings the port does not carry (branched path, other sampling
patterns)."""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.models.node import Node, SocketType as S
from raytracingproject_tpu_torch.utils import rng as rng_mod

METHOD_PATH = 0
METHOD_BRANCHED_PATH = 1


class Integrator(Node):
    SOCKETS = [
        S("method", S.ENUM, "path",
          {"path": METHOD_PATH, "branched_path": METHOD_BRANCHED_PATH}),
        S("max_bounce", S.INT, 7),
        S("max_diffuse_bounce", S.INT, 7),
        S("max_glossy_bounce", S.INT, 7),
        S("max_transmission_bounce", S.INT, 7),
        S("max_volume_bounce", S.INT, 7),
        S("transparent_max_bounce", S.INT, 7),
        S("ao_bounces", S.INT, 0),
        S("ao_factor", S.FLOAT, 1.0),
        S("ao_distance", S.FLOAT, 1e10),
        S("volume_max_steps", S.INT, 1024),
        S("volume_step_rate", S.FLOAT, 1.0),
        S("volume_samples", S.INT, 1),
        S("volume_stack_depth", S.INT, 4),
        S("caustics_reflective", S.BOOLEAN, True),
        S("caustics_refractive", S.BOOLEAN, True),
        S("filter_glossy", S.FLOAT, 0.0),
        S("seed", S.INT, 0),
        S("sample_clamp_direct", S.FLOAT, 0.0),
        S("sample_clamp_indirect", S.FLOAT, 10.0),
        S("aa_samples", S.INT, 128),
        S("sampling_pattern", S.ENUM, "sobol_burley",
          {"sobol_burley": rng_mod.SOBOL_SAMPLER, "pcg": 1, "cmj": 2,
           "pmj02": 3}),
        S("min_bounce", S.INT, 2),
        S("light_sampling_threshold", S.FLOAT, 0.01),
        S("use_light_tree", S.BOOLEAN, False),
        S("adaptive_threshold", S.FLOAT, 0.0),
        S("adaptive_min_samples", S.INT, 0),
    ]

    def kernel_record(self):
        return {
            "method": np.int32(self.get_enum_int("method")),
            "max_bounce": np.int32(self.max_bounce),
            "max_diffuse_bounce": np.int32(self.max_diffuse_bounce),
            "max_glossy_bounce": np.int32(self.max_glossy_bounce),
            "max_transmission_bounce": np.int32(self.max_transmission_bounce),
            "max_volume_bounce": np.int32(self.max_volume_bounce),
            "transparent_max_bounce": np.int32(self.transparent_max_bounce),
            "ao_bounces": np.int32(self.ao_bounces),
            "ao_factor": np.float32(self.ao_factor),
            "ao_distance": np.float32(self.ao_distance),
            "min_bounce": np.int32(self.min_bounce),
            "seed": np.uint32(np.int64(self.seed) & 0xFFFFFFFF),
            "sample_clamp_direct": np.float32(self.sample_clamp_direct),
            "sample_clamp_indirect": np.float32(self.sample_clamp_indirect),
            "filter_glossy": np.float32(self.filter_glossy),
            "caustics_reflective": np.int32(self.caustics_reflective),
            "caustics_refractive": np.int32(self.caustics_refractive),
            "sampling_pattern": np.int32(
                self.get_enum_int("sampling_pattern")),
            "aa_samples": np.int32(self.aa_samples),
            "light_sampling_threshold": np.float32(
                self.light_sampling_threshold),
            "volume_max_steps": np.int32(self.volume_max_steps),
            "volume_step_rate": np.float32(self.volume_step_rate),
            "adaptive_threshold": np.float32(self.adaptive_threshold),
            "adaptive_min_samples": np.int32(self.adaptive_min_samples),
        }
