"""raytracingproject_tpu_torch — the PyTorch + CUDA port of the renderer.

A second package beside `raytracingproject_tpu` (the JAX reference).
It imports `torch`, never `jax`, and nothing of the JAX package: what it
needs from there (the SAH builder, the cluster cut, the PNG writer) it
keeps as its own copy. The port grows slice by slice; it renders the
`glossy_nee_mis`, the `volume_sss` and the `big_instanced`
configurations end to end:

  app/examples.py -> models/ (numpy host compile -> KernelGlobals:
     instancing, two-level cluster tables, lamps, textures, background)
  -> ops/integrator.py render_samples_regen (wavefront, plain torch;
     homogeneous media, random-walk SSS, equiangular volume NEE, image
     and checker textures, distant lamps, the background shader)
  -> ops/cluster_walk.py  (K2, CUDA: per-lane closest / any-hit walk)
  -> ops/tile_walk.py     (K4, CUDA: tile-shared closest / any-hit walk)
  -> ops/cluster2_walk.py (K5, CUDA: two-level tile-shared closest /
     any-hit walk with instance rows)
  -> ops/occlusion_walk.py (K3, CUDA: NEE shadow test and the volume
     NEE's dual sweep)

Module names mirror the JAX package so each counterpart is easy to find.
Features outside the port raise NotImplementedError; none is skipped
silently.
"""

__version__ = "0.1.0"
