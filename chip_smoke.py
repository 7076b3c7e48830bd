"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main paths (raytracingproject_tpu_torch) and its
adaptive loops on the card and fails (nonzero exit, no result line) if any
phase fails:

1. environment: CUDA present; card name and power limit (nvidia-smi),
   torch and CUDA versions; TF32 off (raytracingproject_tpu_torch.device);
2. build: the hand-written kernels compiled from csrc/*.cu, one nvcc call
   per source, all started together; the port's C++ BVH builder
   (native/bvh_builder.cpp, one g++ call) for scenes of 2,048 prims and
   more, with its build time;

glossy_nee_mis (the Cornell box with a GGX sphere; K2 and K3):

3. kernels vs plain versions on the glossy scene's tables: K2 closest and
   any hit, K3 in its surface form and in its dual form (with a seeded
   random volume-boundary table planted, so both minima are exercised),
   and K4 closest and any hit (C = 179), on 65,536 random rays and 65,536
   camera rays; K4's five outputs equal to its scan-order mirror's
   (ops/tile_walk.py tile_scan_order: the warp's visit order) on every
   lane, ties included;
4. accuracy: 64x64, 128 spp, chunk 16, clamp off, rendered on the card
   and held against the float64 twin render artifacts/twin_f64.npz (rmse
   <= 5.7e-5, <= 0.07% of pixels off by more than 1e-3);
5. full width: 512x512, 32 spp (the first 32 of the cell's 64, for the
   script's time), chunk 16, 1 lane per pixel through the CLI code path;
   the image must be finite with a mean within 0.5% of the JAX package's
   mean for the cell's 64-spp render (JAX_MEAN_512), and K2 and K3
   must have been launched by this render. The inputs of the third call
   of each kernel (262,144 lanes; camera, diffuse and glossy visibility
   mixed) are copied as the render runs;
6. main-path shapes: first the counting variants of K2 and K3 run on the
   inputs copied from the render (outputs equal to the plain launch's;
   per lane the mean, p50, p99 and max of the cluster rows and boxes each
   lane tested, per warp the mean of max / mean rows); then at 262,144
   lanes each kernel is held against its plain version and both are
   timed, on the inputs copied from the render (K2 and K3 to the bit:
   t, u, v, prim, object; t_boundary, t_other, blocked) and on camera
   rays / NEE-like shadow rays;

volume_sss (homogeneous smoke and a random-walk SSS sphere in the Cornell
box, with the dispatch the configuration pins: K4 and K3's dual form):

7. kernels vs plain versions on the volume_sss tables: K4 closest and any
   hit (and its scan-order mirror, as in 3), K3's dual form with the
   scene's real volume-boundary table, on 65,536 random rays and 65,536
   camera rays;
8. accuracy: 64x64, 128 spp, chunk 16, clamp off, against
   twin_f64.npz["volume_sss"] (rmse <= 1.15e-4, <= 0.15% of pixels off by
   more than 1e-3: twice the JAX package's own float32 render);
9. full width: 256x256, 16 spp (the first 16 of the cell's 32), chunk 16
   through the CLI code path (example:volume_sss); finite, mean within 1%
   of the JAX package's mean for the cell's render (JAX_MEAN_VOL_256), K4
   and K3 launched by this render; the inputs of each kernel's third
   call are copied;
10. main-path shapes: K3's dual form counted on the copied input as in 6;
   the counting variant of K4 on the copied input (outputs equal to the
   plain launch's and to the scan-order mirror's; per lane the steps of
   its warp, the rows it tested, its box tests and its box passes, equal
   on every lane to those of the queue-order mirror,
   ops/tile_walk.py tile_queue_order, with the scan-order mirror's counts
   of the earlier design beside them); at 65,536 lanes K4 (on the copied
   input and on camera rays: t, u, v equal to the plain version's to the
   bit off exact-t ties, every output equal to the scan-order mirror's)
   and K3's dual form (on the copied input, to the bit) are held against
   their plain versions and both are timed;

big_instanced (64 instances of one image-textured sphere on a checkered
ground plane, a distant sun and a constant sky; two-level cluster tables:
K5 for every closest hit and every NEE shadow test):

11. kernels vs plain versions on the scene's tables (1,025 clusters in 65
   superclusters, instance rows): K5 closest and any hit on 65,536 random
   rays from inside the scene's bounds and 65,536 camera rays; hit masks
   equal, max |dt| 0 off exact ties, tie lanes held to an exact tie; every
   output equal to the scan-order mirror's (ops/cluster2_walk.py
   cluster2_scan_order) on every lane, ties included;
12. accuracy: 64x64, 128 spp, chunk 16, clamp off, against the float64
   twin raytracingproject_tpu_torch/data/twin_big_instanced.npz (made
   once on the CPU with the JAX package by tools/rmse_twin.py's method,
   `python -m tests.test_torch_instanced_render twin f32|f64`; it also
   holds the JAX package's own float32 render): rmse and the share
   of pixels off by more than 1e-3 at most twice the JAX render's own;
13. full width: 256x256, 16 spp, chunk 8 through the CLI code path
   (example:big_instanced); finite, mean within 0.5% of the JAX package's
   mean for the same render (JAX_MEAN_BIG_256), K5 launched by this
   render; the inputs of K5's third call (the second iteration's closest
   hit) and of its third any-hit call are copied;
14. main-path shapes: the counting variant of K5 on both copied inputs
   (outputs equal to the plain launch's and to the scan-order mirror's;
   per lane the superclusters its warp entered, the group tables it
   filled, the rows its warp fetched, the rows it tested, the w2o
   transforms it computed and its supercluster passes, equal on every
   lane to cluster2_queue_order's); at 65,536 lanes K5 on the copied
   inputs and on sun shadow rays from the camera rays' first hits (any
   hit) is held against its plain version and the scan-order mirror, and
   both are timed.

cornell_diffuse (the Cornell box with its two boxes, 36 prims: the dense
sweep K1 for every closest hit and, in its any-hit mode, every NEE shadow
test):

15. K1's closest, any-hit, dual and Moeller-Trumbore modes vs their plain
   versions (ops/intersect.py) on the scene's 36 triangles (a seeded
   boundary mask planted for the dual form), 65,536 random rays with mixed
   per-lane visibility, 65,536 camera rays and the 65,536 rays of the
   grazing set (ops/dense_sweep.py grazing_rays, where the cull's pads are
   tightest) and 65,536 rays nearly along the triangles' edges
   (edge_rays, where the watertight test accepts farthest outside a
   triangle): prims, t, u, v equal to the bit, masks equal;
16. accuracy: 64x64, 128 spp, chunk 16, clamp off, against
   twin_f64.npz["cornell_diffuse"] (rmse <= 5.7e-5, <= 0.07% of pixels off
   by more than 1e-3);
17. full width: 512x512, 32 spp (the first 32 of the cell's 64), chunk 32
   through the CLI code path (example:cornell); finite, mean within 0.5%
   of the JAX package's mean for the cell's render (JAX_MEAN_CORNELL_512),
   K1's closest and any-hit
   modes launched by this render; the inputs of each mode's third call
   are copied;
18. main-path shapes: first the counting variant of each mode runs on
   its copied input (outputs equal to the plain launch's; per lane the
   triangles tested, the blocks kept and the blocks the lane's warp kept;
   the kept blocks, and but for the any-hit mode the triangles tested,
   equal on every lane to those of ops/dense_sweep.py kept_blocks:
   block_keep at gates from the plain watertight test's hits); then at 262,144 lanes the
   two modes are held against their plain versions on the copied inputs
   and timed, with the bound of the tests they ran beside the all-pairs
   bound, and so is the Moeller-Trumbore mode on the copied closest-hit
   rays;

volume_sss under the host compile's own dispatch (1,008 prims: K1 for
every closest hit and, in its dual form, both volume-NEE sweeps):

19. K1's four modes vs their plain versions on the scene's 1,008
   triangles and its real boundary mask, random, camera, grazing and
   edge-on rays, as in 15;
20. accuracy: 64x64, 128 spp against twin_f64.npz["volume_sss"] under
   volume_sss's gate;
21. full width: 256x256, 16 spp, chunk 16 (example:volume_sss:dense);
   mean within 1% of JAX_MEAN_VOL_256, K1's closest mode and dual form
   launched; third calls copied;
22. main-path shapes: the closest mode and the dual form counted on their
   copied inputs as in 18; at 65,536 lanes they and the Moeller-Trumbore
   mode on the copied inputs, held and timed;

big_instanced with pallas_onehot2 (K6 for every closest hit and shadow
test):

23. K6 vs its plain version as K5 in 11, and every output equal to its
   scan-order mirror's (ops/onehot2_walk.py onehot2_scan_order: the first
   design's visit order) on every lane, ties included;
24. full width: 256x256, 16 spp, chunk 8 (example:big_instanced:onehot2);
   mean within 0.5% of JAX_MEAN_BIG_256, K6 launched; the inputs of its
   third closest-hit and third any-hit call are copied;
25. main-path shapes: the counting variant of K6 on both copied inputs
   (outputs equal to the plain launch's and to the scan-order mirror's;
   per lane the superclusters its warp entered, the groups it walked, its
   group box tests and passes, the rows it read and tested, its w2o
   transforms and its supercluster passes, equal on every lane to
   onehot2_queue_order's, with the first design's counts and the warp's
   inner steps beside them); at 65,536 lanes K6 on the copied inputs and
   on sun shadow rays held against its plain version and the scan-order
   mirror and timed, and K5 timed on the copied closest-hit input beside
   it; then the same checks, counts and times on a synthetic two-level
   table at the caps (512 superclusters of 16 clusters of 38 triangles,
   instance rows; ops/onehot2_walk.py grid_tables2) under 65,536 random
   rays, closest and any hit.

glossy_nee_mis in fused-NEE mode (examples.GLOSSY_FUSED: the union walk K7
answers every closest hit and every NEE shadow test; K2 and K3 are not
called):

26. K7 vs its plain version (ops/cluster_intersect.py
   intersect_clusters_dual) on the glossy tables: 65,536 random closest
   rays with mixed per-lane visibility paired with any-hit rays from nearby
   origins toward the lamp, 65,536 camera rays paired with NEE-like shadow
   rays, and each ray of the random pairs switched off by an empty window;
   blocked equal everywhere, the closest hit (t, u, v, prim, object)
   equal to the bit on every lane, ties included: the closest ray visits
   K2's clusters in K2's order;
27. accuracy: 64x64, 128 spp, chunk 16, clamp off, fused, against
   twin_f64.npz["glossy_nee_mis"] under glossy's gate; K7 launched;
28. full width: 512x512, 32 spp, chunk 16 through the CLI code path
   (example:cornell:glossy:fused); finite, mean within 0.5% of
   JAX_MEAN_512, K7 launched and K2 and K3 launched 0 times by this
   render; the inputs of K7's third call (262,144 lanes) are copied;
29. main-path shapes: the counting variant of K7 on the copied input
   (outputs equal to the plain launch's; per lane the rows read, the rows
   read once for both rays, the passes and the boxes tested); at 262,144
   lanes K7 on the copied input is held against its plain version (to the
   bit) and timed, with the bound of the tests it ran; beside it, on the
   same copied rays, K2 (the closest half) and K3 (the any-hit half),
   which is what the fused call replaces, both to the bit;
30. adaptive loop (session/adaptive.py render_adaptive_device): glossy
   256x256, 32 spp, chunk 4, unfused and fused, once with threshold 0
   (every count equals 32, image mean within 0.5% of the fixed render's at
   that size) and once with threshold 0.02 (converged, fewer samples than
   nominal, mean within 1%); the fused runs launch K7 only, the unfused
   ones K2 and K3 only; the third calls of K2 and K3 in the unfused run
   with threshold 0.02 are copied and held against the plain versions to
   the bit.

the JAX package's single-level cap:

31. a table of 640 clusters x 15 random triangles (K2 and K7 take 512,
   K3 and K4 640) through the integrator's dispatch: the closest hit goes
   to K4 and the occlusion walk to K3, K2 is not launched; both are held
   against their plain versions on 65,536 random rays (K3 to the bit, K4
   to its scan-order mirror on every lane) and timed, and K4's counting
   variant is held to the queue-order mirror there.

dof_motion_adaptive (the glossy box through a 12-unit six-bladed lens from
a camera that moves 25 units over the shutter, adaptive sampling at
threshold 0.02; only the camera is new, so K2 and K3 as for glossy):

32. kernels vs plain versions on the dof tables: 65,536 lens-and-motion
   camera rays (ops/camera.py camera_sample_ray at random raster, lens
   and shutter samples) and NEE shadow rays from their first hits: K2
   closest to the bit, K2 any hit (camera and shadow rays) with equal
   masks, K3's surface form to the bit;
33. accuracy: the fixed 64x64, 128 spp, chunk 16 render, clamp off,
   against the JAX package's render of it in float64 throughout, its
   camera's motion included (TWIN_DOF; rmse <= 1.2e-5, twice the JAX
   package's own float32 render against twin_f64; <= 0.07% of pixels
   off by more than 1e-3); the rmse against
   twin_f64.npz["dof_motion_adaptive"] is logged beside it;
34. full width, 256x256, 64 spp, chunk 32: (a) the fixed render of the
   CLI's scene (session/session.py render_fixed): finite, mean within 0.5%
   of the JAX package's mean for the same render (JAX_MEAN_DOF_256); (b)
   the CLI's own render (example:dof_motion), which takes the session's
   adaptive branch: finite, mean within 1% of JAX_MEAN_DOF_256, K2 and K3
   launched and no other walk, the inputs of each kernel's third call
   copied; (c) session/adaptive.py render_adaptive_device under bench.py
   bench_adaptive's protocol (lanes W * H, min_samples 16, chunk 16):
   converged, fewer samples than nominal, finite, mean within 1% of (a)'s
   and of JAX_MEAN_DOF_256;
35. main-path shapes: the counting variants of K2 and K3 on the copied
   inputs (outputs equal to the plain launch's), their rows and boxes per
   lane printed beside glossy's; both held against their plain versions
   on the copied inputs to the bit and timed; then the fixed render, the
   CLI's adaptive render and render_adaptive_device at 32 spp (half the
   cell's budget, for the script's time), three renders each in turns
   (warm from phase 34), Msamples/s as the nominal budget over the wall
   time (median, min-max).

textured_instanced (instanced_scene at grid=4: 16 image-textured spheres
on a checkered ground under a distant sun and a sky, 8,450 prims compiled
flattened through the port's C++ BVH builder to 385 clusters x 30
triangles; K2 for every closest hit, K3's surface form for every sun
shadow test):

36. the host compile (example:textured_instanced), its time and the BVH
   builder's share of it; the dispatch picks K2 and K3; kernels vs plain
   versions on its tables: K2 closest (to the bit) and any hit (masks
   equal) on 65,536 random rays from inside the scene's bounds and 65,536
   camera rays, K3's surface form (to the bit) on sun shadow rays from
   their first hits;
37. accuracy: 64x64, 128 spp, chunk 16, clamp off, against
   artifacts/twin_f64_r04.npz["textured_instanced"] (rmse <= 1.27e-6,
   twice the JAX package's own float32 render against it,
   artifacts/RMSE_r04.json; <= 0.07% of pixels off by more than 1e-3);
   twin_f64.npz's entry for this scene predates the box-filtered checker,
   and the rmse against it is logged beside;
38. full width: 256x256, 64 spp, chunk 32 through the CLI code path
   (example:textured_instanced): finite, mean within 0.5% of the JAX
   package's mean for the same render (JAX_MEAN_TEX_256), K2 and K3
   launched and no other walk; the inputs of each kernel's third call are
   copied;
39. main-path shapes: the counting variants of K2 and K3 on the copied
   inputs (outputs equal to the plain launch's), their rows and boxes per
   lane printed beside glossy's; at 65,536 lanes K2 and K3 held against
   their plain versions (the copied inputs to the bit; camera rays; sun
   shadow rays) and timed;

instanced_scene(grid=5) (25 spheres, 13,202 prims compiled flattened to
599 clusters x 32 triangles, past K2's 512: K4 for every closest hit, K3
for every shadow test; the first real scene over 512 clusters):

40. the host compile, its time and the builder's; the dispatch picks K4
   and K3; K4 closest and any hit against its plain version (t, u, v to
   the bit off exact-t ties) and its scan-order mirror (every output on
   every lane, ties included), and K3's surface form (to the bit), on
   random, camera and sun shadow rays as in 36;
41. reduced render: 128x128, 8 spp, chunk 8 through session.render:
   finite, mean within 0.5% of the JAX package's (JAX_MEAN_TEX5_128), K4
   and K3 launched and no other walk; the inputs of each kernel's third
   call are copied;
42. counts and times: K4's counting variant on the copied input, its
   counts equal to tile_queue_order's on every lane; K4 and K3 held and
   timed on the copied inputs and K4 on 65,536 camera rays, each printed
   beside phase 31's 640-cluster synthetic table.

instanced_scene(grid=6) (36 spheres, 19,010 flat prims, over the flatten
limit: the sphere stays instanced, 530 packed prims in one single-level
table of 577 clusters x 38 triangles with instance rows; K4 for every
closest hit, K3 for every shadow test, both taking each lane's ray to the
row's object space):

43. the host compile (example:instanced_grid6) and its dispatch; K4
   closest and any hit with instance rows against its plain version (t,
   u, v to the bit off exact-t ties) and its scan-order mirror (every
   output on every lane), and K3 with instance rows (to the bit) in its
   surface form on sun shadow rays and its dual form on a seeded random
   boundary table, on 65,536 random rays from inside the scene's bounds
   and 65,536 camera rays;
44. accuracy: 64x64, 128 spp, chunk 16, clamp off, against the JAX
   package's float64 render raytracingproject_tpu_torch/data/
   twin_instanced_grid6.npz (python -m
   tests.test_torch_instanced_single_render6 twin f32|f64): rmse at most
   twice the JAX package's own float32 render's, pixels off by more than
   1e-3 at most twice its share or glossy's 0.07%;
45. full width: 256x256, 64 spp, chunk 32 through the CLI code path
   (example:instanced_grid6): finite, mean within 0.5% of the JAX
   package's (JAX_MEAN_GRID6_256), K4 and K3 launched and no other walk;
   the inputs of each kernel's third call are copied;
46. counts and times: K4's counting variant on the copied input, its
   counts equal to tile_queue_order's (with instance rows) on every lane,
   and K3's; K4 (on the copied input and on camera rays) and K3 (on the
   copied input, to the bit) held against their plain versions and timed.

instanced_scene(grid=5, nlat=15) (25 spheres of 672 triangles, 16,802
flat prims: instanced, 674 packed prims, 401 clusters x 48 with instance
rows; K2 and K3, and in fused-NEE mode K7):

47. the host compile (example:instanced_grid5_nlat15) and its dispatch;
   K2 closest (to the bit) and any hit, and K3's surface and dual forms
   (to the bit), with instance rows, on random and camera rays as in 43;
   K7 with instance rows on those rays paired with the sun shadow rays
   of their first hits (blocked equal, the closest hit to the bit on
   every lane), and with the closest ray switched off;
48. full width: 256x256, 64 spp, chunk 32 through the CLI code path,
   unfused (example:instanced_grid5_nlat15: K2 and K3 launched and no
   other walk) and fused (:fused: K7 launched and no other walk), each
   finite with a mean within 0.5% of the JAX package's unfused render's
   (JAX_MEAN_GRID5N15_256); the inputs of each kernel's third call are
   copied;
49. counts and times: the counting variants of K2, K3 and K7 on the
   copied inputs (outputs equal to the plain launch's); K2 and K3 (to the
   bit) and K7 (blocked equal, the closest hit to the bit) held against
   their plain versions on them and timed, and K2 and K3 on K7's rays
   beside it.

glossy_deform (the glossy box, its mirror sphere on a two-step deform
path: motion cluster rows, 179 clusters x 15 triangles of 328 floats; K2
for every closest hit, K3 for every shadow test, each lane at its ray's
time; K4 in place of K2 under examples.GLOSSY_DEFORM_TILE):

50. the host compile (example:glossy_deform) and its dispatch; K2 (to the
   bit) and K4 (t, u, v to the bit off exact-t ties, every output its
   scan-order mirror's) closest and any hit, K3's surface form (NEE
   shadow rays from the first hits) and dual form (a seeded boundary
   table), to the bit, with motion rows, on 65,536 random and 65,536
   camera rays at seeded times in [0, 1]; then at time 0 every motion
   mode against the same kernel's static walk over the static glossy
   table (the same hits: masks, and t, u, v off exact-t ties; K3 every
   output);
51. accuracy: 64x64, 128 spp, chunk 16, clamp off, against the JAX
   package's float64 render raytracingproject_tpu_torch/data/
   twin_glossy_deform.npz (python -m tests.test_torch_deform_render twin
   glossy f32|f64): rmse at most twice its float32 render's, pixels off by
   more than 1e-3 at most twice its share or 0.07%;
52. full width: 256x256, 64 spp, chunk 32 through the CLI code path,
   example:glossy_deform (K2 and K3 launched and no other walk) and
   example:glossy_deform:tile (K4 and K3), each finite with a mean within
   0.5% of the JAX package's (JAX_MEAN_GLOSSY_DEFORM_256); the inputs of
   each kernel's third call are copied;
53. counts and times: the counting variants of K2 and K3 on the copied
   inputs, of K4 on the tile render's (its counts equal to
   tile_queue_order's at the lanes' times); K2, K3 (to the bit) and K4
   held against their plain versions on them and timed, K2 also on
   camera rays at seeded times.

cornell_deform (the Cornell box, its short box on a three-step deform
path, 36 prims: K1's deform modes for every closest hit and shadow
test):

54. the host compile (example:cornell_deform) and its dispatch; K1's
   closest, any and dual deform modes, on the three-step path and on its
   last step alone, against their plain versions on 65,536 random rays
   (mixed visibility, a tenth of the windows empty), 65,536 camera rays
   and the grazing set, at seeded times: every output to the bit, and on
   the three-step path the counting variant's kept blocks equal to the
   mirror's (ops/dense_sweep.py kept_blocks with the steps); at time 0
   each deform mode equal to the static sweep to the bit;
55. accuracy as in 51 against data/twin_cornell_deform.npz;
56. full width: 256x256, 64 spp, chunk 32 through the CLI code path
   (example:cornell_deform): finite, mean within 0.5% of the JAX
   package's (JAX_MEAN_CORNELL_DEFORM_256), K1's closest and any modes
   launched and nothing else;
57. counts and times: K1's counting variant on the copied closest and
   any-hit inputs (kept blocks equal the mirror's), then each held against
   its plain version (to the bit) and timed.

glossy_deform_big (glossy_deform with a 41,580-triangle mirror sphere on
the same path, 42,552 prims: two-level motion tables, 936 clusters x 64
triangles of 1,357 floats in 25 superclusters; K5 for every closest hit
and shadow test, each lane at its ray's time; K6 in its place under
examples.GLOSSY_DEFORM_BIG_ONEHOT2):

58. the host compile (example:glossy_deform_big) and its dispatch; K5 and
   K6 closest and any hit with motion rows against their plain version
   (t, u, v to the bit off exact-t ties, hit masks equal) and their
   scan-order mirrors at the lanes' times (every output on every lane,
   ties included), on 65,536 random and 65,536 camera rays at seeded
   times in [0, 1] and on NEE shadow rays from the first hits; then at
   time 0 each motion mode against the same kernel's static walk over
   glossy_big's static tables (the same hits: masks, and t, u, v off
   exact-t ties);
59. accuracy: 64x64, 128 spp, chunk 16, clamp off, against the JAX
   package's float64 render by R7's route (its XLA motion walk over the
   same tables; ROADMAP.md section 3) raytracingproject_tpu_torch/data/
   twin_glossy_deform_big.npz (python -m
   tests.test_torch_deform_two_level_render twin f32|f64): rmse at most
   twice its float32 render's, pixels off by more than 1e-3 at most twice
   its share or 0.07%;
60. full width: 256x256, 64 spp, chunk 32 through the CLI code path,
   example:glossy_deform_big (K5 launched and no other walk) and
   example:glossy_deform_big:onehot2 (K6 and no other walk), each finite
   with a mean within 0.5% of the JAX package's by R7's route
   (JAX_MEAN_GLOSSY_DEFORM_BIG_256); the inputs of each kernel's third
   closest-hit and third any-hit call are copied;
61. counts and times: the counting variants of K5 and K6 on the copied
   inputs (outputs equal to the plain launch's and to the scan-order
   mirror's, counts equal to the queue-order mirror's at the lanes'
   times); K5 and K6 held against their plain version on them and timed,
   K5 also on K6's closest-hit input.

Launch counts are set to 0 just before each full-width render and read
just after it; the launches of the comparisons do not count. A kernel's
time is the median of three timings, each the median of 20 runs. Each
kernel's bound (the least time the card could take for the same work) is
computed from the inputs of its timed call: the larger of the bytes it
must move over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
H100 SXM's published peaks). The earlier designs' times are measured by
compare_walks.py (K4, K5; K6 with --kernel k6) and recorded in PERF.md,
not here. The script
takes about 10 to 11 minutes, the kernels' build included.

The last three lines are the card's name and power limit, a JSON line
describing each kernel (with its modes in this run, for K2, K3, K4
and K7 their instance-row mode's launches and time, and for K1's closest
and any modes, K2, K3, K4, K5 and K6 their motion mode's), and {"ok": true,
"device": {...}}.
"""

import contextlib
import importlib
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
N_CHECK = 65536
# which call of each kernel wrapper a full-width render has its inputs
# copied from: by the third wavefront iteration the lanes mix camera
# rays (regenerated paths) with bounce rays
RECORD_CALL = 3
TWIN = "artifacts/twin_f64.npz"
TWIN_F32 = "artifacts/twin_f32.npz"
TIE_FRAC = 1e-4
# volume_sss's Cornell box has two boxes whose bottom faces lie in the
# floor's plane: a ray from below the floor (a quarter of the random rays)
# that meets them hits two coplanar triangles at one t, and the walks'
# visit orders pick different ones. Every such lane is still held to an
# exact tie (t within 1e-6 relative + 1e-4); only their share may be
# larger there.
TIE_FRAC_COPLANAR = 2e-3
# Image means of the JAX package's own render of each full-width cell
# (render_samples_regen on the CPU, chunks of 16, default clamp 10,
# averaged in float64): glossy 512x512x64 and volume_sss 256x256x32. The
# 64x64 twins' means are not the reference here: in both packages the
# image mean moves with resolution (glossy 64x64 0.1727 -> 256x256 0.1784
# at clamp 0).
JAX_MEAN_512 = 0.17757781157033317
JAX_MEAN_VOL_256 = 0.2115986647204958
# big_instanced 256x256x16, chunks of 8, default clamp (the JAX package's
# render_samples_regen on the CPU, which walks its packed BVH there;
# python -m tests.test_torch_instanced_render mean 256 16 8)
JAX_MEAN_BIG_256 = 0.21052450607052078
TWIN_BIG = "raytracingproject_tpu_torch/data/twin_big_instanced.npz"
# cornell_diffuse 512x512x64, chunks of 32, default clamp (the JAX
# package's render_samples_regen on the CPU through its dense sweep;
# python -m tests.test_torch_dense_render mean 512 64 32)
JAX_MEAN_CORNELL_512 = 0.16585140399495943
# the wrappers: kernel name -> (module under ops/, function)
WRAPPERS = {
    "cluster_walk": ("cluster_walk", "intersect_clusters_walk"),
    "occlusion_walk": ("occlusion_walk", "occlusion_clusters_walk"),
    "tile_walk": ("tile_walk", "intersect_clusters_tile"),
    "cluster2_walk": ("cluster2_walk", "intersect_clusters2_walk"),
    "onehot2_walk": ("onehot2_walk", "intersect_clusters2_onehot"),
    "dual_walk": ("dual_walk", "intersect_clusters_dual_walk"),
    "dense_closest": ("dense_sweep", "intersect_brute_sweep"),
    "dense_any": ("dense_sweep", "shadow_blocked_sweep"),
    "dense_dual": ("dense_sweep", "occlusion_sweep"),
    "dense_mt": ("dense_sweep", "intersect_mt_sweep"),
}
# K1's wrappers count launches per mode, in one dict
DENSE_MODE = {"dense_closest": "closest", "dense_any": "any",
              "dense_dual": "dual", "dense_mt": "mt"}
# the plain version of each of them, in ops/intersect.py
DENSE_PLAIN = {"dense_closest": "intersect_brute",
               "dense_any": "shadow_blocked_brute",
               "dense_dual": "intersect_brute_occlusion",
               "dense_mt": "intersect_brute_mt"}
# operation counts of the walks' two tests (float32 arithmetic and
# comparisons, counted from csrc/watertight.cuh) and the card's peaks
SLAB_OPS = 27      # slab_entry: one ray against one cluster box
TRI_OPS = 110      # wt_tri_v: one ray against one triangle
# K5 per instance row a lane visits: the w2o transform of origin and
# direction (33, csrc/cluster2_walk.cu) and a new shear basis (68,
# wt_setup in csrc/watertight.cuh)
XFORM_OPS = 33 + 68
# one ray against one triangle in Moeller-Trumbore arithmetic (counted from
# csrc/dense_sweep.cu dense_mt_kernel)
MT_OPS = 56
# K1's cull: one lane against one block's padded box (counted from
# csrc/dense_sweep.cu keep_block)
KEEP_OPS = 40
# a triangle lerped to a lane's time (motion rows, K1's deform modes, a
# segment of the path): nine multiplies and nine adds
LERP_OPS = 18
# the grazing set of K1's checks (ops/dense_sweep.py grazing_rays)
N_GRAZING = 65536
# the adaptive phase: glossy at ADAPTIVE_SIZE^2, and the threshold of the
# run that stops pixels early
ADAPTIVE_SIZE, ADAPTIVE_SPP, ADAPTIVE_CHUNK = 256, 32, 4
ADAPTIVE_THRESHOLD = 0.02
# the JAX package's single-level cap: the largest table K3 and K4 take
# (K2 and K7 take 512)
CAP_CLUSTERS = 640
# K6's synthetic table at the two-level caps: superclusters (K5 and K6
# take 512), clusters a group, triangles a cluster (big_instanced's 38):
# 8,192 rows, 15.4 MB
K6_CAP = (512, 16, 38)
# dof_motion_adaptive 256x256x64, chunks of 32, default clamp (the JAX
# package's render_samples_regen on the CPU, float64 sum; python -m
# tests.test_torch_dof_render mean 256 64 32)
JAX_MEAN_DOF_256 = 0.17784439539401029
DOF_SIZE, DOF_SPP, DOF_CHUNK = 256, 64, 32
DOF_THRESHOLD, DOF_MIN_SAMPLES = 0.02, 16
# its 64x64x128 gate: twice the JAX package's own f32 render against
# twin_f64 (rmse 6.02e-6, artifacts/RMSE_r04.json), glossy's share of
# pixels off by more than 1e-3. The reference is the JAX package's render
# in float64 throughout (python -m tests.test_torch_dof_render twin
# TWIN_DOF): twin_f64 computes the camera's motion in float32 (the dtype
# of its motion record), so its camera-to-world rounds by a float32 ulp
# or two, differently under each compilation of the loop, and camera rays
# that graze a glossy sphere turn with it (pixels (3, 1), (10, 39) and
# (56, 11) of twin_f64 change with the loop and the wavefront's shape)
DOF_RMSE_GATE, DOF_FRAC_GATE = 1.2e-5, 0.0007
TWIN_DOF = "raytracingproject_tpu_torch/data/twin_dof_motion.npz"
# textured_instanced 256x256x64, chunks of 32, default clamp (the JAX
# package's render_samples_regen on the CPU, float64 sum, with the port's
# BVH builder in place of its own, whose numbering races at this size;
# python -m tests.test_torch_textured_render mean 256 64 32 4)
JAX_MEAN_TEX_256 = 0.22633297881757933
TEX_SIZE, TEX_SPP, TEX_CHUNK = 256, 64, 32
# its 64x64x128 gate: twice the JAX package's own f32 render (rmse
# 6.36e-7, artifacts/RMSE_r04.json), glossy's share of pixels off by more
# than 1e-3 (the JAX render's own share is 0). RMSE_r04.json compares the
# round-4 pair TWIN_R04 / TWIN_F32_R04, the reference here: in twin_f64.npz
# and twin_f32.npz this scene's entries predate the box-filtered checker
# (7.06e-3 from TWIN_R04, where every other scene's entries are equal to
# it), and today's JAX package's float64 render is 5.1e-8 from it
# (tests/test_torch_textured_render.py wavefronts); the rmse against
# twin_f64.npz is logged beside it
TEX_RMSE_GATE, TEX_FRAC_GATE = 1.27e-6, 0.0007
TWIN_R04, TWIN_F32_R04 = ("artifacts/twin_f64_r04.npz",
                          "artifacts/twin_f32_r04.npz")
# instanced_scene(grid=5): 13,202 prims compiled flattened to 599 clusters
# x 32 triangles, past K2's 512: K4 and K3. Its render at 128x128x8,
# chunks of 8 (the same way: python -m tests.test_torch_textured_render
# mean 128 8 8 5)
JAX_MEAN_TEX5_128 = 0.21918006322018926
GRID5_SIZE, GRID5_SPP, GRID5_CHUNK = 128, 8, 8
# instance rows in single-level tables: instanced_scene(grid=6) (19,010
# flat prims, over the flatten limit: 577 clusters x 38 triangles with
# instance rows; K4 and K3) and instanced_scene(grid=5, nlat=15) (16,802:
# 401 x 48; K2 and K3, K7 in fused-NEE mode), at textured_instanced's
# 256x256x64 in chunks of 32. The JAX package's means of those renders
# (render_samples_regen on the CPU, float64 sum, strips of 64 rows;
# python -m tests.test_torch_instanced_single_render6 mean 256 64 32 6 12,
# and ... 5 15)
JAX_MEAN_GRID6_256 = 0.21469840995201514
JAX_MEAN_GRID5N15_256 = 0.21926015638785956
INST_SIZE, INST_SPP, INST_CHUNK = 256, 64, 32
# grid=6's 64x64x128 twin, clamp off: the JAX package's render in float32
# ("f32_jax") and in float64 ("f64"; python -m
# tests.test_torch_instanced_single_render6 twin f32|f64); the gate is
# twice the float32 render's own rmse against the float64 one
TWIN_GRID6 = "raytracingproject_tpu_torch/data/twin_instanced_grid6.npz"
# deforming motion: glossy_deform (the glossy box, its mirror sphere on a
# two-step path: motion cluster rows, K2 and K3; K4 and K3 under
# examples.GLOSSY_DEFORM_TILE) and cornell_deform (the Cornell box, its
# short box on a three-step path: K1's deform modes), 256x256x64 in
# chunks of 32. The JAX package's means of those renders
# (render_samples_regen on the CPU, float64 sum, strips of 64 rows;
# python -m tests.test_torch_deform_render mean glossy|cornell 256 64 32;
# the tile dispatch is the same estimator) and their 64x64x128 twins,
# clamp off, in float32 ("f32_jax") and float64 ("f64"; python -m
# tests.test_torch_deform_render twin glossy|cornell f32|f64)
JAX_MEAN_GLOSSY_DEFORM_256 = 0.17661716007537295
JAX_MEAN_CORNELL_DEFORM_256 = 0.1653792549472399
DEFORM_SIZE, DEFORM_SPP, DEFORM_CHUNK = 256, 64, 32
# glossy_deform_big (glossy_deform with a 41,580-triangle mirror sphere:
# two-level motion tables, 936 clusters x 64 in 25 superclusters; K5, and
# K6 under examples.GLOSSY_DEFORM_BIG_ONEHOT2), 256x256x64 in chunks of
# 32. The JAX package's CPU dispatch renders this scene as if nothing
# moved (R7, ROADMAP.md section 3); by R7's route (sc_bounds dropped from
# its kernel globals) it walks the motion rows with its XLA walk. Its mean
# that way over the first 16 of the 64 samples of each pixel
# (render_samples_regen on the CPU, float64 sum; all 64 would take about
# five CPU hours; the mean of the four strips of 64 rows printed by
# python -m tests.test_torch_deform_two_level_render mean 256 16 16 Y0
# Y0+64), and its 64x64x128 twin, clamp off, in float32 and float64
# (... twin f32|f64)
JAX_MEAN_GLOSSY_DEFORM_BIG_256 = 0.1767239634197858
TWIN_DEFORM = {name: f"raytracingproject_tpu_torch/data/twin_{name}.npz"
               for name in ("glossy_deform", "cornell_deform",
                            "glossy_deform_big")}
# each kernel's modes in this run, and, for the single-level walks whose
# instance-row mode is in this run, that mode's timed case and the paths
# that launch it (and alike for the motion modes)
MODES = {"dense_closest": ["closest", "mt", "deform"],
         "dense_any": ["any", "deform"],
         "dense_dual": ["dual", "deform"],
         "cluster_walk": ["closest", "any", "instance rows", "motion rows"],
         "occlusion_walk": ["surface", "dual", "instance rows",
                            "motion rows"],
         "tile_walk": ["closest", "any", "instance rows", "motion rows"],
         "cluster2_walk": ["closest", "any", "instance rows", "motion rows"],
         "onehot2_walk": ["closest", "any", "instance rows", "motion rows"],
         "dual_walk": ["dual", "instance rows"]}
INSTANCE_CASES = {"cluster_walk": "K2 closest render (grid=5 nlat=15)",
                  "occlusion_walk": "K3 surface render (grid=6)",
                  "tile_walk": "K4 closest render (grid=6)",
                  "dual_walk": "K7 dual render (grid=5 nlat=15)"}
INSTANCE_PATHS = ("instanced_grid6", "instanced_grid5_nlat15",
                  "instanced_grid5_nlat15_fused")
MOTION_CASES = {"dense_closest": "K1 closest render (cornell_deform)",
                "dense_any": "K1 any render (cornell_deform)",
                "cluster_walk": "K2 closest render (glossy_deform)",
                "occlusion_walk": "K3 surface render (glossy_deform)",
                "tile_walk": "K4 closest render (glossy_deform tile)",
                "cluster2_walk": "K5 closest render (glossy_deform_big)",
                "onehot2_walk": "K6 closest render (glossy_deform_big)"}
MOTION_PATHS = ("glossy_deform", "glossy_deform_tile", "cornell_deform",
                "glossy_deform_big", "glossy_deform_big_onehot2")
# timed renders per driver in the fixed-vs-adaptive measurement, and
# their budget: half the cell's 64 spp, for the script's time
DOF_RENDERS = 3
DOF_TIMED_SPP = 32
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def module(name):
    return importlib.import_module(
        f"raytracingproject_tpu_torch.ops.{WRAPPERS[name][0]}")


def wrapper(name):
    return getattr(module(name), WRAPPERS[name][1])


def launches_of(name):
    count = module(name).launches
    return count[DENSE_MODE[name]] if name in DENSE_MODE else count


def reset_launches():
    for name in WRAPPERS:
        mod = module(name)
        if name in DENSE_MODE:
            mod.launches[DENSE_MODE[name]] = 0
        else:
            mod.launches = 0


def median_ms(fn, reps):
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def random_rays(n, rng, dev, lo=(-300,) * 3, hi=(900,) * 3):
    """Rays as in the JAX package's one-hot walk tests: origins uniform
    in a box around the scene (lo, hi), isotropic directions."""
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, device=dev), torch.tensor(d, device=dev))


def camera_rays(kg, width, height, dev):
    """Pixel-center camera rays of a width x height film."""
    from raytracingproject_tpu_torch.ops import camera as cam_ops
    cam = dict(kg["cam"])
    sx, sy = width / float(cam["width"]), height / float(cam["height"])
    yy, xx = np.mgrid[0:height, 0:width]
    rx = torch.tensor((xx.reshape(-1) + 0.5) / sx, dtype=torch.float32,
                      device=dev)
    ry = torch.tensor((yy.reshape(-1) + 0.5) / sy, dtype=torch.float32,
                      device=dev)
    z = torch.zeros_like(rx)
    ray = cam_ops.camera_sample_ray(cam, rx, ry, z, z, z)
    return ray["o"].contiguous(), ray["d"].contiguous()


def compare_hits(name, ref, got, tie_frac=TIE_FRAC):
    """Hit masks equal; prim/object equal except exact-t ties (t within
    rtol 1e-6 + atol 1e-4; at most tie_frac of the lanes); t rtol 1e-5,
    u/v atol 1e-5 on the lanes that agree. Returns max |t| error on those
    lanes."""
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    assert np.array_equal(ref["prim"] >= 0, got["prim"] >= 0), \
        f"{name}: hit masks differ"
    same = (ref["prim"] == got["prim"]) & (ref["object"] == got["object"])
    tie = ~same
    if tie.any():
        # a differing winner must be an exact tie in t: the two hits' t
        # round in the ray's shear frame, so agree to ~1 ulp of the
        # scene's coordinates (1e-4 at ~556) beside 1e-6 relative
        assert np.allclose(ref["t"][tie], got["t"][tie], rtol=1e-6,
                           atol=1e-4), f"{name}: prims differ off an exact tie"
    frac = float(tie.mean())
    assert frac <= tie_frac, f"{name}: {frac} of lanes differ in prim"
    np.testing.assert_allclose(got["t"][same], ref["t"][same], rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["u"][same], ref["u"][same], atol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["v"][same], ref["v"][same], atol=1e-5,
                               err_msg=name)
    err = float(np.abs(got["t"][same] - ref["t"][same]).max())
    tie_rel = float((np.abs(got["t"][tie] - ref["t"][tie])
                     / np.abs(ref["t"][tie])).max()) if tie.any() else 0.0
    log(f"[kernels] {name}: {len(same)} lanes, hit "
        f"{float((ref['prim'] >= 0).mean()):.4f}, tie lanes "
        f"{int(tie.sum())} (max relative dt {tie_rel:.2e}), max |dt| "
        f"{err:.3e} on the others")
    return err


def compare_any_hit(name, ref, got):
    """Any hit: the blocked masks (prim >= 0) are equal."""
    assert torch.equal(ref["prim"] >= 0, got["prim"] >= 0), \
        f"{name}: blocked masks differ"
    log(f"[kernels] {name}: {ref['prim'].shape[0]} lanes, masks equal, hit "
        f"{float((got['prim'] >= 0).float().mean()):.4f}")
    return 0.0


def compare_walk(name, ref, got, any_hit, tie_frac=TIE_FRAC):
    if any_hit:
        return compare_any_hit(name, ref, got)
    return compare_hits(name, ref, got, tie_frac)


def compare_occlusion(name, ref, got, need_boundary=False):
    """K3: blocked masks equal; t_boundary and t_other within rtol 1e-5.
    Returns the max |t| error over both minima."""
    (rb, ro, rblk), (gb, go, gblk) = ref, got
    assert torch.equal(rblk, gblk), f"{name}: blocked masks differ"
    err = 0.0
    for nm, a, b in (("t_boundary", rb, gb), ("t_other", ro, go)):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   rtol=1e-5, err_msg=f"{name} {nm}")
        err = max(err, float((b - a).abs().max()))
    nb = float((rb < 1e29).float().mean())
    if need_boundary:
        assert nb > 0.0, f"{name}: no lane found a boundary prim"
    log(f"[kernels] {name}: {rb.shape[0]} lanes, blocked equal "
        f"({float(gblk.float().mean()):.4f} blocked), t_boundary found "
        f"{nb:.4f}, t_other found {float((ro < 1e29).float().mean()):.4f}, "
        f"max |dt| {err:.3e}")
    return err


def exactly(compare):
    """`compare`, then every output equal to the plain version's to the
    bit (K2's t, u, v, prim, object; K3's t_boundary, t_other,
    blocked)."""
    def held(name, ref, got):
        err = compare(name, ref, got)
        keys = ref.keys() if isinstance(ref, dict) else range(len(ref))
        for k in keys:
            assert torch.equal(ref[k], got[k]), \
                f"{name}: output {k} differs from the plain version's"
        log(f"[kernels] {name}: every output equal to the plain version's "
            "to the bit")
        return err
    return held


# the tile-shared walks and K6 and their plain torch mirrors of the visit
# order: (scan order, the earlier design's; queue order, the kernel's)
ORDER_MIRRORS = {"tile_walk": ("tile_scan_order", "tile_queue_order"),
                 "cluster2_walk": ("cluster2_scan_order",
                                   "cluster2_queue_order"),
                 "onehot2_walk": ("onehot2_scan_order",
                                  "onehot2_queue_order")}
# the walks on two-level tables (instance rows)
TWO_LEVEL = ("cluster2_walk", "onehot2_walk")
# the columns of their counts: the kernel's (= the queue-order mirror's)
# and the scan-order mirror's
ORDER_COUNTS = {"tile_walk": ("warp steps", "rows tested", "box tests",
                              "passes"),
                "cluster2_walk": ("superclusters entered", "group fills",
                                  "rows fetched", "rows tested",
                                  "transforms", "supercluster passes"),
                "onehot2_walk": ("superclusters entered", "groups walked",
                                 "group box tests", "group passes",
                                 "rows read", "rows tested", "transforms",
                                 "supercluster passes")}
# K6's scan-order mirror counts what the first design did: a rescan a
# visit, a transform a row, a table scan a pick
SCAN_COUNTS = {"tile_walk": ("warp steps", "rows tested", "entries read"),
               "cluster2_walk": ORDER_COUNTS["cluster2_walk"][:5],
               "onehot2_walk": ORDER_COUNTS["onehot2_walk"]}


def order_mirror(name, args, any_hit, queue=False, instances=False,
                 motion=None):
    """The scan-order (queue=False) or queue-order mirror of K4
    ("tile_walk"; args: the walk's eight positional arguments; instance
    rows with instances=True; motion rows at the lanes' times with
    motion=time), K5 ("cluster2_walk") or K6 ("onehot2_walk"; args:
    sc_bounds, cbounds, ctable, cluster_tris, gmax, o, d, tmin, tmax,
    visibility; instance rows, or motion rows with motion=time) on the
    kernel's inputs: (hit dict, counts), for K6 also the warp's inner
    steps."""
    fn = getattr(module(name), ORDER_MIRRORS[name][int(queue)])
    kw = _order_kw(name, any_hit, instances, motion)
    return fn(*args, **kw)


def _order_kw(name, any_hit, instances, motion):
    """The keyword arguments of an order-mirror call and its kernel's:
    the two-level walks take instance rows unless they take motion
    rows."""
    kw = {"shadow_any_hit": any_hit}
    if instances or (name in TWO_LEVEL and motion is None):
        kw["has_instances"] = True
    if motion is not None:
        kw.update(time=motion, has_motion=True)
    return kw


def held_to_scan_order(label, name, args, any_hit, got, instances=False,
                       motion=None):
    """Every output of K4, K5 or K6 equal to its scan-order mirror's on
    every lane, exact-t ties included: the kernel visits the earlier
    design's clusters in that design's order. Returns the mirror's
    counts."""
    mirror, counts = order_mirror(name, args, any_hit,
                                  instances=instances, motion=motion)[:2]
    for k in mirror:
        assert torch.equal(got[k], mirror[k]), \
            f"{label}: output {k} differs from the scan-order mirror's"
    log(f"[kernels] {label}: every output equal to the scan-order "
        "mirror's on every lane")
    return counts


def exact_off_ties(compare):
    """`compare`, then t, u and v equal to the plain version's to the bit
    on every lane whose prim and object agree with it."""
    def held(name, ref, got, *extra):
        err = compare(name, ref, got, *extra)
        same = (ref["prim"] == got["prim"]) & \
            (ref["object"] == got["object"])
        for k in ("t", "u", "v"):
            assert torch.equal(ref[k][same], got[k][same]), \
                f"{name}: {k} differs from the plain version's off the ties"
        return err
    return held


def in_scan_order(compare, name, args, any_hit, instances=False,
                  motion=None):
    """A K4, K5 or K6 case's check: `compare` (for a closest hit t, u, v to
    the bit off the ties), then held_to_scan_order."""
    base = compare if any_hit else exact_off_ties(compare)

    def held(label, ref, got, *extra):
        err = base(label, ref, got, *extra)
        held_to_scan_order(label, name, args, any_hit, got, instances,
                           motion)
        return err
    return held


def column_stats(cnt, names):
    """Per column of int counts the lanes' mean, p50, p99 and max."""
    x = cnt.to(torch.float64)
    q = torch.quantile(x, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                       device=x.device), dim=0)
    return {nm: {"mean": float(x[:, j].mean()), "p50": float(q[0, j]),
                 "p99": float(q[1, j]), "max": float(x[:, j].max())}
            for j, nm in enumerate(names)}


def order_count_phase(label, name, args, any_hit, instances=False,
                      motion=None):
    """The counting variant of K4, K5 or K6 on one input: its outputs
    equal the plain launch's and the scan-order mirror's, and its counts
    equal the queue-order mirror's on every lane. Prints and returns
    their per-column stats, with the scan-order mirror's counts (the
    earlier design's) beside them; for K6 also the warp's inner steps
    (the sum over its groups of the most rows a lane read) against the
    rows a lane read."""
    kw = _order_kw(name, any_hit, instances, motion)
    kern = wrapper(name)
    ref = kern(*args, **kw)
    got, cnt = kern(*args, counts=True, **kw)
    sync()
    assert all(torch.equal(ref[k], got[k]) for k in ref), \
        f"{label}: the counting variant's outputs differ"
    scnt = held_to_scan_order(label, name, args, any_hit, got, instances,
                              motion)
    queue = order_mirror(name, args, any_hit, queue=True,
                         instances=instances, motion=motion)
    assert torch.equal(cnt, queue[1]), \
        f"{label}: the counts differ from the queue-order mirror's"
    st = {"kernel": column_stats(cnt, ORDER_COUNTS[name]),
          "earlier design": column_stats(scnt, SCAN_COUNTS[name])}
    fmt = lambda d: "; ".join(
        f"{k} " + "/".join(f"{v[q]:.2f}" for q in ("mean", "p50", "p99",
                                                    "max"))
        for k, v in d.items())
    log(f"[counts] {label} ({cnt.shape[0]} lanes; mean/p50/p99/max), equal "
        f"to the queue-order mirror's on every lane: {fmt(st['kernel'])}; "
        f"the earlier design's (scan-order mirror): "
        f"{fmt(st['earlier design'])}")
    if name == "onehot2_walk":
        steps = float(queue[2].to(torch.float64).mean())
        rows = float(cnt[:, 4].to(torch.float64).mean())
        st["warp_inner_steps_mean"] = steps
        st["warp_steps_over_lane_rows"] = steps / max(rows, 1e-30)
        log(f"[counts] {label}: the warp's inner steps {steps:.2f} a lane "
            f"against rows read {rows:.2f} a lane (ratio "
            f"{st['warp_steps_over_lane_rows']:.2f})")
    return st


def count_stats(cnt):
    """Per lane mean, p50, p99 and max of the rows and the boxes a walk
    tested (the first two columns of its int32 counts), per warp (32
    consecutive lanes) the mean of max / mean rows over the warps whose
    lanes test any row, and for K3 (a third column: the rows the lane's
    warp staged) the staged rows per warp and the lanes that test a
    staged row."""
    c = cnt.to(torch.float64)
    out = {}
    for j, key in enumerate(("rows", "boxes")):
        x = c[:, j]
        q = torch.quantile(x, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                           device=x.device))
        out[key] = {"mean": float(x.mean()), "p50": float(q[0]),
                    "p99": float(q[1]), "max": float(x.max())}
    n = c.shape[0] // 32 * 32
    w = c[:n, 0].reshape(-1, 32)
    m = w.mean(1)
    busy = m > 0
    out["warp_max_over_mean_rows"] = float(
        (w.max(1).values[busy] / m[busy]).mean())
    out["warps_without_rows"] = float((~busy).to(torch.float64).mean())
    if c.shape[1] > 2:   # K3: the rows each warp staged
        staged = c[:n, 2].reshape(-1, 32).max(1).values
        out["staged_rows_per_warp"] = float(staged.mean())
        out["lanes_per_staged_row"] = float(w.sum() / staged.sum())
    return out


def count_phase(label, name, rec):
    """The counting variant of K2 or K3 on a recorded call: its outputs
    equal the plain launch's; prints and returns count_stats (for K2 also
    the box tests of the earlier design, a full rescan per visit and one
    more that found nothing: (rows + 1) x C on a closest-hit call)."""
    args = _positional(name, rec)
    kern = wrapper(name)
    if name == "occlusion_walk":
        ref = kern(*args)
        got, cnt = kern(*args, counts=True)
    else:
        kw = _walk_kw(args)
        ref = kern(*args[:8], **kw)
        got, cnt = kern(*args[:8], counts=True, **kw)
    sync()
    keys = ref.keys() if isinstance(ref, dict) else range(len(ref))
    assert all(torch.equal(ref[k], got[k]) for k in keys), \
        f"{label}: the counting variant's outputs differ"
    st = count_stats(cnt)
    c = int(args[0].shape[0])
    extra = ""
    if name == "cluster_walk" and not args[8]:
        st["boxes_rescan_design_mean"] = float(
            (cnt[:, 0].to(torch.float64) + 1.0).mean()) * c
        extra = (f"; the rescan design's box tests per lane "
                 f"{st['boxes_rescan_design_mean']:.2f}")
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())
    log(f"[counts] {label} ({cnt.shape[0]} lanes, C = {c}): rows per lane "
        f"{fmt(st['rows'])}; boxes per lane {fmt(st['boxes'])}; warp max / "
        f"mean rows {st['warp_max_over_mean_rows']:.3f} (warps without rows "
        f"{st['warps_without_rows']:.4f}){extra}")
    if "staged_rows_per_warp" in st:
        log(f"[counts] {label}: rows staged per warp "
            f"{st['staged_rows_per_warp']:.2f}, lanes testing a staged row "
            f"{st['lanes_per_staged_row']:.3f}")
    return st


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _prims_per_cluster(ctable, ct):
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    pb = ci.prim_col(ct, ci.is_motion_table(ctable, ct))
    return (ctable[:, pb:pb + ct] >= 0).sum(1).to(torch.float64)


def walk_bound(args, kw, out):
    """(bound ms, bound_by) of one closest- or any-hit walk call (K2, K4).
    Bytes: tables, rays and results once. Operations: every lane tests
    every cluster box once; a closest-hit lane tests the triangles of each
    cluster it enters before its final t (a miss: every cluster it
    enters); an any-hit lane that hits tests one triangle. With instance
    rows (has_instances in kw) each cluster a lane tests also costs it a
    transform of its ray (XFORM_OPS), as in cluster2_bound; with motion
    rows (has_motion) each triangle test its lerp to the lane's time
    (LERP_OPS), and the lanes' times are read once."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    cb, ctab, ct, o, d, tmin, tmax, vis = args[:8]
    any_hit = bool(kw.get("shadow_any_hit", False))
    xform = XFORM_OPS if kw.get("has_instances", False) else 0
    lerp = LERP_OPS if kw.get("has_motion", False) else 0
    tm = kw.get("time") if lerp else None
    entry = ci.entry_table(cb, o, d, tmin, tmax)
    entered = entry < ci.INF
    if not any_hit:
        entered = entered & (entry < out["t"][None])
    per = _prims_per_cluster(ctab, int(ct)) * (TRI_OPS + lerp) + xform
    row_ops = (entered.to(torch.float64) * per[:, None]).sum(0)
    if any_hit:
        row_ops = torch.where(out["prim"] >= 0,
                              float(TRI_OPS + lerp + xform), row_ops)
    n, c = o.shape[0], cb.shape[0]
    ops = n * c * SLAB_OPS + float(row_ops.sum())
    return _bound(_nbytes(cb, ctab, o, d, tmin, tmax, vis, tm,
                          *out.values()), ops)


def occlusion_bound(args, out):
    """(bound ms, bound_by) of one K3 call: every lane tests every cluster
    box once and the triangles of each cluster it enters below its final
    gate (a blocked lane at least one triangle); with instance rows
    (args[11]) a transform of its ray (XFORM_OPS) for each such cluster;
    with motion rows (args[13]) a lerp (LERP_OPS) for each triangle test,
    the lanes' times (args[12]) read once."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    cb, ctab, cbd, ct, o, d, tmin, tmaxc, tmaxa = args[:9]
    xform = XFORM_OPS if len(args) > 11 and args[11] else 0
    motion = len(args) > 13 and bool(args[13])
    lerp = LERP_OPS if motion else 0
    t_b, t_o, blocked = out
    entry = ci.entry_table(cb, o, d, tmin, torch.maximum(tmaxc, tmaxa))
    gate = ci.occlusion_gate(t_b, t_o, blocked, tmaxc, tmaxa)
    per = _prims_per_cluster(ctab, int(ct)) * (TRI_OPS + lerp) + xform
    row_ops = ((entry < gate[None]).to(torch.float64) * per[:, None]).sum(0)
    row_ops = torch.where(blocked, torch.clamp(
        row_ops, min=float(TRI_OPS + lerp + xform)), row_ops)
    n, c = o.shape[0], cb.shape[0]
    ops = n * c * SLAB_OPS + float(row_ops.sum())
    return _bound(_nbytes(cb, ctab, cbd, o, d, tmin, tmaxc, tmaxa,
                          args[12] if motion else None, t_b, t_o, blocked),
                  ops)


def check_walks(kg, n_check, rng, walks, occlusion_forms,
                random_tie_frac=TIE_FRAC):
    """Each closest-hit walk in `walks` (closest and any hit) and K3 in
    each of `occlusion_forms` against its plain version, on random and
    camera rays; returns max |t| error per kernel. The "planted" dual
    form runs on a seeded random 0/1 volume-boundary table, the "dual"
    form on the scene's own. Exact-t ties may take up random_tie_frac of
    the random rays' lanes, TIE_FRAC of the camera rays'."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    dev = ds["cluster_table"].device
    cb, ct_, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    planted = torch.tensor(rng.integers(0, 2, cbd.shape).astype(np.float32),
                           device=dev)
    ctris = int(kg["cluster_tris"])
    side = int(round(n_check ** 0.5))
    errs = {k: 0.0 for k in walks}
    if occlusion_forms:
        errs["occlusion_walk"] = 0.0
    for label, (o, d), tmin0 in (
            ("random", random_rays(n_check, rng, dev), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tmin = torch.full((n,), tmin0, device=dev)
        tmax = torch.full((n,), 1e30, device=dev)
        vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
        for any_hit in (False, True):
            ref = ci.intersect_clusters(cb, ct_, ctris, o, d, tmin, tmax,
                                        vis, shadow_any_hit=any_hit)
            for name in walks:
                got = wrapper(name)(cb, ct_, ctris, o, d, tmin, tmax, vis,
                                    shadow_any_hit=any_hit)
                sync()
                mode = "any-hit" if any_hit else "closest"
                compare = compare_walk
                if name == "tile_walk":
                    compare = in_scan_order(
                        compare_walk, name,
                        (cb, ct_, ctris, o, d, tmin, tmax, vis), any_hit)
                errs[name] = max(errs[name], compare(
                    f"{name} {mode} {label}", ref, got, any_hit,
                    random_tie_frac if label == "random" else TIE_FRAC))
        tmax_any = torch.tensor(
            np.where(rng.uniform(size=n) < 0.5, rng.uniform(10, 800, n),
                     1e30).astype(np.float32), device=dev)
        for form in occlusion_forms:
            tmaxc = tmin if form == "surface" else torch.tensor(
                rng.uniform(10, 1000, n).astype(np.float32), device=dev)
            bnd = planted if form == "planted" else cbd
            args = (cb, ct_, bnd, ctris, o, d, tmin, tmaxc, tmax_any, 1, 128)
            ref = ci.occlusion_clusters(*args)
            got = wrapper("occlusion_walk")(*args)
            sync()
            errs["occlusion_walk"] = max(errs["occlusion_walk"],
                                         compare_occlusion(
                f"occlusion_walk {form} {label}", ref, got,
                need_boundary=form != "surface"))
    return errs


@contextlib.contextmanager
def record_calls(names, nth):
    """While active, each named wrapper copies the arguments of its nth
    call into the yielded {name: store} ("args", "kw"; those of its nth
    any-hit call under "any") and then runs as before (so it still
    launches and counts every call)."""
    stores = {}
    origs = {}
    for name in names:
        mod, fn_name = module(name), WRAPPERS[name][1]
        orig = getattr(mod, fn_name)
        origs[name] = (mod, fn_name, orig)
        store = stores[name] = {}

        def recording(*args, _orig=orig, _store=store, _calls=[0, 0], **kw):
            _calls[0] += 1
            any_hit = bool(kw.get("shadow_any_hit", False))
            _calls[1] += any_hit
            if _calls[0] == nth or (any_hit and _calls[1] == nth):
                copy = {"args": tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args),
                        "kw": {k: v.clone() if torch.is_tensor(v) else v
                               for k, v in kw.items()}}
                if _calls[0] == nth:
                    _store.update(copy)
                if any_hit and _calls[1] == nth:
                    _store["any"] = copy
            return _orig(*args, **kw)

        setattr(mod, fn_name, recording)
    try:
        yield stores
    finally:
        for mod, fn_name, orig in origs.values():
            setattr(mod, fn_name, orig)


def shadow_rays(kg, o, d, rng):
    """NEE-like shadow rays: from the camera rays' first hits toward
    uniform points on the first light triangle."""
    ds = kg["dscene"]
    dev = o.device
    n = o.shape[0]
    vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
    hit = wrapper("cluster_walk")(
        ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
        o, d, torch.zeros(n, device=dev), torch.full((n,), 1e30, device=dev),
        vis)
    P = o + hit["t"][:, None] * d
    lr = ds["le_prim_rows"][0, :9].reshape(3, 3)
    uv = torch.tensor(rng.uniform(size=(n, 2)).astype(np.float32),
                      device=dev)
    su = uv[:, 0].sqrt()
    Pl = lr[0] + (lr[1] - lr[0]) * (1 - su)[:, None] \
        + (lr[2] - lr[0]) * (uv[:, 1] * su)[:, None]
    to_l = Pl - P
    dist = to_l.norm(dim=-1).clamp(min=1e-8)
    sd = (to_l / dist[:, None]).contiguous()
    so = (P + sd * 1e-2).contiguous()
    stmin = torch.full((n,), 1e-5, device=dev)
    stmax = torch.where(hit["prim"] >= 0, dist * (1 - 1e-3) - 1e-2, stmin)
    return so, sd, stmin, stmax.contiguous()


def timed_cases(cases, n, card, reps=(20, 3)):
    """Each case (kernel call, plain call, kernel name, compare, bound[,
    counted bound]): held against its plain version, then both timed: the
    kernel three times (each the median of reps[0] runs; "ms" is the
    median of the three), the plain version once. A sixth element gives
    the bound of the tests the kernel ran, from its counting variant.
    Returns ({case: {"ms", "ms_runs", "plain_ms", "bound_ms", "bound_by",
    "lanes"[, "counted_bound_ms"]}}, {kernel: max |t| error})."""
    times, errs = {}, {}
    for name, (kern, plain, which, compare, bound, *counted) in cases.items():
        got, ref = kern(), plain()
        sync()
        errs[which] = max(errs.get(which, 0.0),
                          compare(f"{name} @ {n}", ref, got))
        bound_ms, bound_by = bound(ref)
        runs = [median_ms(kern, reps[0]) for _ in range(3)]
        ms, plain_ms = float(np.median(runs)), median_ms(plain, reps[1])
        times[name] = {"ms": ms, "ms_runs": runs, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "lanes": n}
        extra = ""
        if counted:
            times[name]["counted_bound_ms"] = counted[0]()
            extra += (f", bound of the tests it ran "
                      f"{times[name]['counted_bound_ms']:.5f} ms")
        log(f"[time] {name} @ {n} lanes: kernel {ms:.4f} ms (median of "
            f"three timings of {reps[0]} runs, {min(runs):.4f}-"
            f"{max(runs):.4f}), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}){extra} ({card})")
    return times, errs


def _plain(name):
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    return (ci.occlusion_clusters if name == "occlusion_walk"
            else ci.intersect_clusters)


def _positional(name, rec):
    """A recorded call's arguments as the plain version's positional
    arguments, in its order (the integrator passes some by keyword)."""
    params = inspect.signature(_plain(name)).parameters
    # flags the plain version does not take must be off in the recorded call
    assert not any(v for k, v in rec["kw"].items() if k not in params)
    kw = {k: v for k, v in rec["kw"].items() if k in params}
    bound = inspect.signature(_plain(name)).bind(*rec["args"], **kw)
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def _walk_kw(args):
    """A closest-hit walk's keyword arguments from the plain version's
    positional ones (shadow_any_hit, has_instances, time, has_motion)."""
    return {"shadow_any_hit": args[8], "has_instances": args[9],
            "time": args[10], "has_motion": args[11]}


def _recorded_case(name, rec, compare):
    """A timed case on a recorded call of wrapper `name`."""
    args = _positional(name, rec)
    if name == "occlusion_walk":
        return (lambda: wrapper(name)(*args), lambda: _plain(name)(*args),
                name, compare, lambda out: occlusion_bound(args, out))
    kw = _walk_kw(args)
    return (lambda: wrapper(name)(*args[:8], **kw),
            lambda: _plain(name)(*args),
            name, compare, lambda out: walk_bound(args, kw, out))


def _lane_visibility(name, rec):
    rvis = _positional(name, rec)[7]
    kinds = sorted(int(x) for x in torch.unique(rvis).cpu())
    shares = [round(float((rvis == k).float().mean()), 4) for k in kinds]
    return kinds, shares


def glossy_main_path_checks(kg, side, rng, card, rec, shadows=None,
                            suffix=""):
    """At side x side lanes: K2 closest on the render's recorded input and
    on camera rays, K2 any-hit on NEE-like shadow rays (`shadows(kg, o,
    d, rng)`, by default shadow_rays), K3 on the render's recorded input
    and on the shadow rays. Each case's name ends in `suffix`."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    cb, ct_, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    ctris = int(kg["cluster_tris"])
    o, d = camera_rays(kg, side, side, cb.device)
    n = o.shape[0]
    zeros = torch.zeros(n, device=cb.device)
    big = torch.full((n,), 1e30, device=cb.device)
    vis = torch.full((n,), 1, dtype=torch.int32, device=cb.device)
    so, sd, stmin, stmax = (shadows or shadow_rays)(kg, o, d, rng)
    svis = torch.full((n,), 128, dtype=torch.int32, device=cb.device)
    for r in rec.values():
        assert r["args"][4].shape[0] == n, "recorded call is not full width"
    kinds, shares = _lane_visibility("cluster_walk", rec["cluster_walk"])
    log(f"[main-path] recorded K2 input{suffix}: visibility values {kinds}, "
        f"lane shares {shares}")
    assert len(kinds) > 1, "the recorded K2 call holds no bounce rays"
    k2, k3 = wrapper("cluster_walk"), wrapper("occlusion_walk")
    cam = (cb, ct_, ctris, o, d, zeros, big, vis)
    shadow = (cb, ct_, ctris, so, sd, stmin, stmax, svis)
    occ = (cb, ct_, cbd, ctris, so, sd, stmin, stmin, stmax, 1, 128)
    cases = {
        "K2 closest render": _recorded_case("cluster_walk",
                                            rec["cluster_walk"],
                                            exactly(compare_hits)),
        "K2 closest camera": (
            lambda: k2(*cam), lambda: ci.intersect_clusters(*cam),
            "cluster_walk", compare_hits,
            lambda out: walk_bound(cam, {}, out)),
        "K2 any-hit shadow": (
            lambda: k2(*shadow, shadow_any_hit=True),
            lambda: ci.intersect_clusters(*shadow, shadow_any_hit=True),
            "cluster_walk", compare_any_hit,
            lambda out: walk_bound(shadow, {"shadow_any_hit": True}, out)),
        "K3 surface render": _recorded_case("occlusion_walk",
                                            rec["occlusion_walk"],
                                            exactly(compare_occlusion)),
        "K3 surface shadow": (
            lambda: k3(*occ), lambda: ci.occlusion_clusters(*occ),
            "occlusion_walk", compare_occlusion,
            lambda out: occlusion_bound(occ, out)),
    }
    return timed_cases({name + suffix: case for name, case in cases.items()},
                       n, card)


def volume_main_path_checks(kg, side, card, rec):
    """At side x side lanes (the render's own width): K4 closest on the
    render's recorded input and on camera rays, K3's dual form on the
    render's recorded input (the real boundary table)."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    cb, ct_ = ds["cluster_bounds"], ds["cluster_table"]
    ctris = int(kg["cluster_tris"])
    o, d = camera_rays(kg, side, side, cb.device)
    n = o.shape[0]
    cam = (cb, ct_, ctris, o, d, torch.zeros(n, device=cb.device),
           torch.full((n,), 1e30, device=cb.device),
           torch.full((n,), 1, dtype=torch.int32, device=cb.device))
    for r in rec.values():
        assert r["args"][4].shape[0] == n, "recorded call is not full width"
    kinds, shares = _lane_visibility("tile_walk", rec["tile_walk"])
    log(f"[main-path] recorded K4 input: visibility values {kinds}, lane "
        f"shares {shares}")
    assert len(kinds) > 1, "the recorded K4 call holds no bounce rays"
    ra = _positional("occlusion_walk", rec["occlusion_walk"])
    log(f"[main-path] recorded K3 input: closest window on "
        f"{float((ra[7] > 1e-5).float().mean()):.4f}, any-hit window on "
        f"{float((ra[8] > 1e-5).float().mean()):.4f} of the lanes")
    k4 = wrapper("tile_walk")
    rk4 = _positional("tile_walk", rec["tile_walk"])
    cases = {
        "K4 closest render": _recorded_case(
            "tile_walk", rec["tile_walk"],
            in_scan_order(compare_hits, "tile_walk", rk4[:8], rk4[8])),
        "K4 closest camera": (
            lambda: k4(*cam), lambda: ci.intersect_clusters(*cam),
            "tile_walk", in_scan_order(compare_hits, "tile_walk", cam, False),
            lambda out: walk_bound(cam, {}, out)),
        "K3 dual render": _recorded_case(
            "occlusion_walk", rec["occlusion_walk"],
            exactly(lambda *a: compare_occlusion(*a, need_boundary=True))),
    }
    return timed_cases(cases, n, card)


def accuracy(dev, twin_key, scene, flags, rmse_gate, frac_gate, spp=128,
             twin=None, twin_f32=None, also=(), unstable=()):
    """The scene's fixed 64x64 x spp render (every pixel spp samples, also
    for a scene that declares adaptive sampling), clamp off, vs the
    float64 twin; the rmse against each (label, image) of `also` is
    logged. `unstable`: ((row, column), value) pairs of pixels whose JAX
    float32 value moves with the compilation (`value`: the JAX package's
    float32 value under another compilation than the twin's): each must
    be within 1e-3 (sum over RGB) of the twin's or of `value`, and the
    gates hold on the other pixels (the rmse over all is logged)."""
    from raytracingproject_tpu_torch.session.session import render_fixed
    if twin is None:
        twin = np.load(TWIN)[twin_key]
        twin_f32 = np.load(TWIN_F32)[twin_key]
    scene.integrator.set("sample_clamp_indirect", 0.0)
    scene.device_update()
    kg = scene.make_kernel_globals(dev)
    kg.update(flags)
    t0 = time.perf_counter()
    img = render_fixed(kg, spp, chunk=16)
    dt = time.perf_counter() - t0
    assert np.isfinite(img).all() and img.shape == twin.shape
    diff = img.astype(np.float64) - twin
    stable = np.ones(twin.shape[:2], bool)
    for (r, c), value in unstable:
        stable[r, c] = False
        off = min(np.abs(diff[r, c]).sum(), np.abs(img[r, c] - value).sum())
        log(f"[accuracy] {twin_key}: unstable pixel ({r}, {c}): port "
            f"{np.round(img[r, c], 8).tolist()}, twin "
            f"{np.round(twin[r, c], 8).tolist()}, the JAX package's float32 "
            f"under another compilation {np.round(value, 8).tolist()}; off "
            f"the nearer by {off:.3e}")
        assert off <= 1e-3, f"{twin_key}: unstable pixel ({r}, {c}) is " \
            "neither the twin's nor the other compilation's"
    rmse_all = float(np.sqrt(np.mean(diff * diff)))
    rmse = float(np.sqrt(np.mean(diff[stable] ** 2)))
    frac = float((np.abs(diff[stable]).sum(-1) > 1e-3).mean())
    d32 = img.astype(np.float64) - twin_f32
    size = img.shape[0]
    off = np.abs(diff).sum(-1)
    worst = np.unravel_index(int(np.argmax(off)), off.shape)
    rest = np.sqrt((np.sum(diff * diff) - np.sum(diff[worst] ** 2))
                   / (diff.size - 3))
    log(f"[accuracy] {twin_key} {size}x{size}x{spp} in {dt:.2f} s: rmse vs "
        f"twin_f64 {rmse:.3e} (gate {rmse_gate}), pixels off >1e-3 "
        f"{frac:.5f} (gate {frac_gate}), rmse vs twin_f32 "
        f"{np.sqrt(np.mean(d32 * d32)):.3e}, mean {img.mean():.6f} vs twin "
        f"{twin.mean():.6f}; worst pixel (row, column) "
        f"{tuple(map(int, worst))} off by {off[worst]:.3e} (sum over RGB; "
        f"port {np.round(img[worst], 8).tolist()}, twin "
        f"{np.round(twin[worst], 8).tolist()}), rmse without it {rest:.3e}")
    if unstable:
        log(f"[accuracy] {twin_key}: the gates hold on the "
            f"{int(stable.sum())} stable pixels; rmse over all "
            f"{rmse_all:.3e}")
    for label, ref in also:
        d = img.astype(np.float64) - ref
        log(f"[accuracy] {twin_key}: rmse vs {label} "
            f"{np.sqrt(np.mean(d * d)):.3e}")
    assert rmse <= rmse_gate and frac <= frac_gate, \
        f"{twin_key}: accuracy gate failed"
    return float(twin.mean())


def full_width(card, spec, width, spp, ref_mean, mean_gate, path_kernels,
               device="cuda", chunk=16):
    """The full-width render through the CLI code path. Every kernel's
    launch count is set to 0 just before it and read just after; each
    kernel of `path_kernels` must have launched. Returns the counts and
    the recorded inputs of each path kernel's RECORD_CALL-th call."""
    from raytracingproject_tpu_torch.app import cli
    args = cli.build_parser().parse_args(
        [spec, "--samples", str(spp), "--width", str(width), "--height",
         str(width), "--chunk", str(chunk), "--lanes-per-pixel", "1",
         "--device", device])
    return path_render(card, spec, width, spp, chunk, ref_mean, mean_gate,
                       path_kernels, lambda: cli.run(args))


def path_render(card, spec, width, spp, chunk, ref_mean, mean_gate,
                path_kernels, run):
    """run() -> (image, stats) renders a width x width x spp image of the
    path `spec`; launch counts are set to 0 just before it and read just
    after, the image is held to the JAX package's mean, and each kernel
    of `path_kernels` must have launched. Returns the counts, the
    recorded inputs of each path kernel's RECORD_CALL-th call and the
    stats."""
    with record_calls(path_kernels, RECORD_CALL) as rec:
        reset_launches()
        img, st = run()
        launches = {name: launches_of(name) for name in WRAPPERS}
    mean = float(img.astype(np.float64).mean())
    mean_rel = abs(mean / ref_mean - 1.0)
    log(f"[render] {spec} {width}x{width}x{spp} chunk {chunk}: "
        f"{st['render_s']:.3f} s, {st['msamples_per_s']:.4f} Msamples/s on "
        f"{card}; host compile {st['compile_s']:.3f} s; mean {mean:.8f} "
        f"(JAX package {ref_mean:.8f}, rel {mean_rel:.2e}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    assert img.shape == (width, width, 3) and np.isfinite(img).all()
    assert mean_rel <= mean_gate, f"{spec}: full-width mean off the JAX " \
        "package's"
    for name in path_kernels:
        assert launches[name] > 0, f"{spec}: the render did not launch {name}"
        assert "args" in rec[name], f"{spec}: no {name} call was recorded"
    return launches, rec, st


def scene_box(kg):
    """The union of the cluster boxes: the scene's bounds."""
    cb = kg["dscene"]["cluster_bounds"].cpu().numpy()
    return cb[:, :3].min(0), cb[:, 3:].max(0)


def k5_call(kg, o, d, tmin, tmax, vis, any_hit, kernel="cluster2_walk"):
    """K5, K6 (kernel="onehot2_walk") or, kernel=None, their plain version
    on the scene's tables."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    tabs = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]))
    if kernel:
        return wrapper(kernel)(
            ds["sc_bounds"], *tabs, int(kg["sc_gmax"]), o, d, tmin, tmax,
            vis, shadow_any_hit=any_hit, has_instances=True)
    return ci.intersect_clusters(*tabs, o, d, tmin, tmax, vis,
                                 shadow_any_hit=any_hit, has_instances=True)


def k5_args(kg, o, d, tmin, tmax, vis):
    """K5's positional arguments on the scene's tables (its mirrors'
    too)."""
    ds = kg["dscene"]
    return (ds["sc_bounds"], ds["cluster_bounds"], ds["cluster_table"],
            int(kg["cluster_tris"]), int(kg["sc_gmax"]), o, d, tmin, tmax,
            vis)


def cluster2_bound(kg, args, any_hit, out, time=None):
    """(bound ms, bound_by) of one K5 or K6 call (the work a lane must do
    is the same in both). Bytes: tables, rays and
    results once. Operations: every lane tests every supercluster box; a
    closest-hit lane tests the cluster boxes of each group it enters
    before its final t, and in each cluster it enters before its final t
    the instance transform (instance rows) and the triangles (a miss:
    every group and cluster it enters); an any-hit lane that hits needs
    one transform and one triangle. With motion rows (the lanes' times
    given) each triangle test also lerps the triangle (LERP_OPS), and the
    times are read once."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    scb, cb, ctab = ds["sc_bounds"], ds["cluster_bounds"], \
        ds["cluster_table"]
    o, d, tmin, tmax, vis = args
    sc_entry = ci.entry_table(scb[:, :6], o, d, tmin, tmax)
    c_entry = ci.entry_table(cb, o, d, tmin, tmax)
    sc_in, c_in = sc_entry < ci.INF, c_entry < ci.INF
    if not any_hit:
        sc_in = sc_in & (sc_entry < out["t"][None])
        c_in = c_in & (c_entry < out["t"][None])
    gboxes = (sc_in.to(torch.float64)
              * scb[:, 7].to(torch.float64)[:, None]).sum(0)
    xform = XFORM_OPS if kg.get("has_instances") else 0
    tri = TRI_OPS + (LERP_OPS if time is not None else 0)
    per_cluster = _prims_per_cluster(ctab, int(kg["cluster_tris"])) \
        * tri + xform
    row_ops = (c_in.to(torch.float64) * per_cluster[:, None]).sum(0)
    if any_hit:
        row_ops = torch.where(out["prim"] >= 0, float(tri + xform),
                              row_ops)
    n = o.shape[0]
    ops = n * scb.shape[0] * SLAB_OPS + float(gboxes.sum()) * SLAB_OPS \
        + float(row_ops.sum())
    return _bound(_nbytes(scb, cb, ctab, *args, time, *out.values()), ops)


def check_cluster2(kg, n_check, rng, kernel="cluster2_walk"):
    """K5 (or K6) against its plain version, closest and any hit, on
    random rays from inside the scene's bounds and on camera rays: hit
    masks equal, max |dt| 0 off exact ties. Returns max |t| error."""
    dev = kg["dscene"]["cluster_table"].device
    side = int(round(n_check ** 0.5))
    lo, hi = scene_box(kg)
    err = 0.0
    for label, (o, d), tmin0 in (
            ("random", random_rays(n_check, rng, dev, lo, hi), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tmin = torch.full((n,), tmin0, device=dev)
        tmax = torch.full((n,), 1e30, device=dev)
        vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
        for any_hit in (False, True):
            ref = k5_call(kg, o, d, tmin, tmax, vis, any_hit, kernel=None)
            got = k5_call(kg, o, d, tmin, tmax, vis, any_hit, kernel)
            sync()
            mode = "any-hit" if any_hit else "closest"
            compare = compare_walk
            if kernel in TWO_LEVEL:
                compare = in_scan_order(compare_walk, kernel, k5_args(
                    kg, o, d, tmin, tmax, vis), any_hit)
            e = compare(f"{kernel} {mode} {label}", ref, got, any_hit)
            assert e == 0.0, f"{kernel} {mode} {label}: |dt| {e} off the ties"
            err = max(err, e)
    return {kernel: err}


def sun_shadow_rays(kg, o, d, rng, hit=None):
    """NEE shadow rays toward the distant lamp from the rays' first hits
    (`hit`; by default the plain two-level walk's closest hits of o, d;
    directions from the port's own light sampler); lanes that miss get
    the empty window [1e-5, 1e-5], as the integrator gives them."""
    from raytracingproject_tpu_torch.ops import light as light_ops
    dev = o.device
    n = o.shape[0]
    if hit is None:
        vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
        hit = k5_call(kg, o, d, torch.zeros(n, device=dev),
                      torch.full((n,), 1e30, device=dev), vis, False, None)
    P = o + hit["t"][:, None] * d
    u = [torch.tensor(rng.uniform(size=n).astype(np.float32), device=dev)
         for _ in range(3)]
    ls = light_ops.sample_light(kg["dscene"], P, *u,
                                static_kinds=kg["light_kinds"])
    sd = ls["D"].contiguous()
    so = (P + sd * 1e-3).contiguous()
    stmin = torch.full((n,), 1e-5, device=dev)
    stmax = torch.where(hit["prim"] >= 0, ls["dist"], stmin).contiguous()
    return so, sd, stmin, stmax


def big_main_path_checks(kg, side, rng, card, rec, kernel="cluster2_walk",
                         counts=None):
    """At side x side lanes (the render's own width): K5 (or K6) closest
    on the render's recorded input, any-hit on the render's recorded
    any-hit input and on sun shadow rays, after its counting variant on
    both recorded inputs (stats into `counts`); with K6, K5 is timed on
    the same recorded closest-hit input beside it."""
    tag = {"cluster2_walk": "K5", "onehot2_walk": "K6"}[kernel]
    ra = inspect.signature(wrapper(kernel)).bind(
        *rec["args"], **rec["kw"])
    ra.apply_defaults()
    a = ra.arguments
    n = a["o"].shape[0]
    assert n == side * side, "recorded call is not full width"
    assert not a["shadow_any_hit"], "the recorded call is not a closest hit"
    rvis = a["visibility"]
    kinds = sorted(int(x) for x in torch.unique(rvis).cpu())
    log(f"[main-path] recorded {tag} input: visibility values {kinds}, lane "
        f"shares {[round(float((rvis == k).float().mean()), 4) for k in kinds]}")
    assert len(kinds) > 1, "the recorded call holds no bounce rays"
    rargs = (a["o"], a["d"], a["tmin"], a["tmax"], a["visibility"])
    o, d = camera_rays(kg, side, side, a["o"].device)
    so, sd, stmin, stmax = sun_shadow_rays(kg, o, d, rng)
    sargs = (so, sd, stmin, stmax,
             torch.full((n,), 128, dtype=torch.int32, device=o.device))

    def case(args, any_hit, compare, which=kernel):
        compare = in_scan_order(compare, which, k5_args(kg, *args), any_hit)
        return (lambda: k5_call(kg, *args, any_hit, which),
                lambda: k5_call(kg, *args, any_hit, None),
                which, compare,
                lambda out: cluster2_bound(kg, args, any_hit, out))

    cases = {f"{tag} closest render": case(rargs, False, compare_hits),
             f"{tag} any-hit shadow": case(sargs, True, compare_any_hit)}
    ra = inspect.signature(wrapper(kernel)).bind(
        *rec["any"]["args"], **rec["any"]["kw"])
    ra.apply_defaults()
    b = ra.arguments
    assert b["shadow_any_hit"] and b["o"].shape[0] == n
    aargs = (b["o"], b["d"], b["tmin"], b["tmax"], b["visibility"])
    cases[f"{tag} any-hit render"] = case(aargs, True, compare_any_hit)
    for mode, args, any_hit in (("closest", rargs, False),
                                ("any-hit", aargs, True)):
        counts[f"big_instanced render ({mode})"] = order_count_phase(
            f"{tag} {mode}, big_instanced render", kernel,
            k5_args(kg, *args), any_hit)
    if kernel == "onehot2_walk":
        cases["K5 closest on K6's render input"] = case(
            rargs, False, compare_hits, "cluster2_walk")
    log(f"[main-path] sun shadow rays: {float((stmax > 1e-5).float().mean()):.4f}"
        " of the lanes have a segment")
    return timed_cases(cases, n, card)


def dense_plain(name):
    from raytracingproject_tpu_torch.ops import intersect as isect
    return getattr(isect, DENSE_PLAIN[name])


def dense_tables(kg, rng):
    """(tri_verts, prim_object, object_visibility, boundary mask) of a
    use_brute scene; a scene without volume gets a seeded boundary mask
    planted, so that both minima of the dual form are exercised."""
    ds = kg["dscene"]
    bnd = ds["prim_is_boundary"]
    if not bool(bnd.any()):
        bnd = torch.tensor(rng.uniform(size=bnd.shape[0]) < 0.3,
                           device=bnd.device)
    return (ds["tri_verts_world"], ds["prim_object_packed"],
            ds["object_visibility"], bnd)


def mt_packets(tri_verts, prim_object):
    """The (nb, 8, 3) v0/e1/e2 packets of the Moeller-Trumbore mode."""
    from raytracingproject_tpu_torch.ops import intersect as isect
    _nb, v0, e1, e2, _po, _pv = isect.pack_tri_blocks(tri_verts, prim_object,
                                                      None)
    return tuple(x.contiguous() for x in (v0, e1, e2))


def compare_equal(name, ref, got):
    """K1 follows its plain version's winner rule literally: every output
    equal to the bit. Returns the max |t| error (0)."""
    for k in ref:
        assert torch.equal(ref[k], got[k]), f"{name}: {k} differs"
    log(f"[kernels] {name}: {ref['t'].shape[0]} lanes, hit "
        f"{float((ref['prim'] >= 0).float().mean()):.4f}, prim, t, u, v "
        "equal to the bit")
    return 0.0


def compare_blocked(name, ref, got):
    assert torch.equal(ref, got), f"{name}: blocked masks differ"
    log(f"[kernels] {name}: {ref.shape[0]} lanes, masks equal, blocked "
        f"{float(ref.float().mean()):.4f}")
    return 0.0


def compare_dual(name, ref, got):
    e = compare_occlusion(name, ref, got, need_boundary=True)
    assert e == 0.0, f"{name}: |dt| {e}"
    return e


DENSE_COMPARE = {"dense_closest": compare_equal, "dense_any": compare_blocked,
                 "dense_dual": compare_dual, "dense_mt": compare_equal}


def dense_bound(name, args, kw, out):
    """(bound ms, bound_by) of one K1 call. Bytes: triangles, rays and
    results once. Operations: a closest-hit, dual or Moeller-Trumbore lane
    with a non-empty window tests every triangle; an any-hit lane that is
    blocked needs one test, an unblocked one with a window every
    triangle."""
    sig = inspect.signature(dense_plain(name)).bind(*args, **kw)
    a = sig.arguments
    if name == "dense_mt":
        p = a["tri_v0"].shape[0] * a["tri_v0"].shape[1]
        tests = float((a["tmax"] > a["tmin"]).sum()) * p
        per_test = MT_OPS
    else:
        p = a["tri_verts"].shape[0]
        per_test = TRI_OPS + _lerp_ops(a)
        if name == "dense_dual":
            window = torch.maximum(a["tmax_closest"], a["tmax_any"]) \
                > a["tmin"]
            tests = float(window.sum()) * p
        else:
            window = a["tmax"] > a["tmin"]
            per_lane = torch.where(window, float(p), 0.0)
            if name == "dense_any":
                per_lane = torch.where(out, 1.0, per_lane)
            tests = float(per_lane.sum())
    outs = out.values() if isinstance(out, dict) else (
        out if isinstance(out, tuple) else (out,))
    return _bound(_nbytes(*a.values(), *outs), tests * per_test)


def _lerp_ops(a):
    """K1's deform modes: the operations of one triangle's lerp to a
    lane's time (LERP_OPS a segment of its path), 0 without them."""
    steps = a.get("tri_verts_t1")
    if steps is None:
        return 0
    return LERP_OPS * (steps.shape[0] if steps.dim() == 4 else 1)


def check_dense(kg, n_check, rng, label):
    """K1's four modes against their plain versions on the scene's dense
    arrays: random rays with mixed per-lane visibility and a tenth of the
    windows empty, camera rays, and the grazing set (ops/dense_sweep.py
    grazing_rays: rays aimed at corners and edge midpoints, axis-parallel
    rays, zero direction components, origins on the triangles with tmin
    1e-5, rays crossing a plane at a grazing angle just outside an edge,
    rays nearly along an edge) and the edge-on set (ops/dense_sweep.py
    edge_rays) with mixed visibility. Returns max |t| error per mode."""
    from raytracingproject_tpu_torch.ops import dense_sweep as k1
    tv, po, ov, bnd = dense_tables(kg, rng)
    dev = tv.device
    side = int(round(n_check ** 0.5))
    packets = mt_packets(tv, po)
    errs = {k: 0.0 for k in DENSE_MODE}
    kinds = np.array([1, 8, 16, 4, 128], np.int32)
    o, d = random_rays(n_check, rng, dev)
    ray_sets = [("random", o, d, torch.full((n_check,), 1e-4, device=dev))]
    o, d = camera_rays(kg, side, side, dev)
    ray_sets.append(("camera", o, d, torch.zeros(o.shape[0], device=dev)))
    ray_sets.append(("grazing", *k1.grazing_rays(tv, N_GRAZING, SEED)))
    ray_sets.append(("edge-on", *k1.edge_rays(tv, N_GRAZING, SEED + 1)))
    for rays, o, d, tmin in ray_sets:
        n = o.shape[0]
        empty = torch.tensor(rng.uniform(size=n) < (
            0.1 if rays == "random" else 0.0), device=dev)
        tmax = torch.where(empty, tmin, 1e30)
        tmax_any = torch.tensor(
            np.where(rng.uniform(size=n) < 0.5, rng.uniform(10, 800, n),
                     1e30).astype(np.float32), device=dev)
        tmax_c = torch.tensor(rng.uniform(10, 1000, n).astype(np.float32),
                              device=dev)
        vis = torch.tensor(kinds[rng.integers(0, 5, n)] if rays != "camera"
                           else np.ones(n, np.int32), device=dev)
        svis = torch.full((n,), 128, dtype=torch.int32, device=dev)
        calls = {
            "dense_closest": (tv, po, o, d, tmin, tmax, vis, ov),
            "dense_any": (tv, po, o, d, tmin, tmax_any, svis, ov),
            "dense_dual": (tv, po, bnd, o, d, tmin, tmax_c, tmax_any, vis,
                           svis, ov),
            "dense_mt": (*packets, o, d, tmin, tmax),
        }
        for name, args in calls.items():
            ref, got = dense_plain(name)(*args), wrapper(name)(*args)
            sync()
            errs[name] = max(errs[name], DENSE_COMPARE[name](
                f"{name} {label} {rays}", ref, got))
    return errs


def _tensors(x):
    """The output tensors of a wrapper call, in order (a dict's values, a
    tuple's items, recursively, or the tensor itself)."""
    if isinstance(x, dict):
        return list(x.values())
    if isinstance(x, tuple):
        return [t for y in x for t in _tensors(y)]
    return [x]


def _dense_counted(name, args, kw):
    """K1's counting variant on a call: (outputs, (N, 3) counts)."""
    out = wrapper(name)(*args, counts=True, **kw)
    if name == "dense_dual":
        return out[:3], out[3]
    return out


def dense_count_phase(label, name, rec):
    """The counting variant of K1 on a recorded call: outputs equal the
    plain launch's, the kept blocks (and, but for the any-hit mode, the
    triangles tested) equal ops/dense_sweep.py kept_blocks's on every
    lane. Prints and returns per lane the mean, p50, p99 and max of the
    triangles tested and the blocks kept over the lanes with a window, the
    warp's kept blocks over the lane's own, and the share of lanes with a
    window."""
    from raytracingproject_tpu_torch.ops import dense_sweep as k1
    from raytracingproject_tpu_torch.ops import intersect as isect
    args, kw = rec["args"], rec["kw"]
    a = inspect.signature(dense_plain(name)).bind(*args, **kw)
    a.apply_defaults()
    a = a.arguments
    ref = wrapper(name)(*args, **kw)
    got, cnt = _dense_counted(name, args, kw)
    sync()
    assert all(torch.equal(x, y) for x, y in zip(
        _tensors(ref), _tensors(got))), \
        f"{label}: the counting variant's outputs differ"
    keep, tested = k1.kept_blocks(name[len("dense_"):], a)
    kept = keep.sum(1).to(torch.int32)
    assert torch.equal(cnt[:, 1], kept), \
        f"{label}: kept blocks differ from block_keep's on " \
        f"{int((cnt[:, 1] != kept).sum())} lanes"
    if tested is not None:
        assert torch.equal(cnt[:, 0], tested), \
            f"{label}: triangles tested differ from the mirror's"
    c = cnt.to(torch.float64)
    if name == "dense_dual":
        live = (a["tmax_closest"] > a["tmin"]) | (a["tmax_any"] > a["tmin"])
    else:
        live = a["tmax"].clamp(max=1e30) > a["tmin"]
    st = {"live_share": float(live.to(torch.float64).mean())}
    nb = (a["tri_verts"].shape[0] + isect.TRI_BLOCK - 1) // isect.TRI_BLOCK
    for j, key in enumerate(("tested", "kept", "warp_kept")):
        x = c[live, j]
        q = torch.quantile(x, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                           device=x.device))
        st[key] = {"mean": float(x.mean()), "p50": float(q[0]),
                   "p99": float(q[1]), "max": float(x.max())}
    st["kept_share"] = st["kept"]["mean"] / nb
    st["warp_over_own"] = st["warp_kept"]["mean"] / max(st["kept"]["mean"],
                                                        1e-9)
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())
    log(f"[counts] {label} ({cnt.shape[0]} lanes, {nb} blocks, "
        f"{st['live_share']:.4f} with a window): per lane with a window "
        f"triangles tested {fmt(st['tested'])}; blocks kept "
        f"{fmt(st['kept'])} ({st['kept_share']:.4f} of the blocks); its "
        f"warp's kept blocks {fmt(st['warp_kept'])} ({st['warp_over_own']:.2f}"
        f"x its own); kept blocks equal block_keep's on every lane"
        + ("" if tested is None else ", triangles tested the mirror's"))
    return st


def dense_counted_bound(name, args, kw):
    """(bound ms) of the tests a K1 call ran, from its counting variant:
    every lane with a window evaluates keep_block for every block
    (KEEP_OPS) and the watertight test for each triangle it tested; bytes
    as dense_bound's."""
    from raytracingproject_tpu_torch.ops import intersect as isect
    out, cnt = _dense_counted(name, args, kw)
    a = inspect.signature(dense_plain(name)).bind(*args, **kw).arguments
    if name == "dense_dual":
        live = (a["tmax_closest"] > a["tmin"]) | (a["tmax_any"] > a["tmin"])
    else:
        live = a["tmax"].clamp(max=1e30) > a["tmin"]
    nb = (a["tri_verts"].shape[0] + isect.TRI_BLOCK - 1) // isect.TRI_BLOCK
    ops = float(live.sum()) * nb * KEEP_OPS \
        + float(cnt[:, 0].to(torch.float64).sum()) * (TRI_OPS + _lerp_ops(a))
    return _bound(_nbytes(*a.values(), *_tensors(out)), ops)[0]


def dense_main_path_checks(kg, label, n, card, rec):
    """At the render's own width: each recorded K1 call (the third of its
    mode in the full-width render) held against its plain version and
    timed, and the Moeller-Trumbore mode on the recorded closest-hit
    rays."""
    cases = {}
    for name, r in rec.items():
        args, kw = r["args"], r["kw"]
        lanes = inspect.signature(dense_plain(name)).bind(
            *args, **kw).arguments["o"].shape[0]
        assert lanes == n, "recorded call is not full width"
        cases[f"K1 {DENSE_MODE[name]} render ({label})"] = (
            lambda name=name, args=args, kw=kw: wrapper(name)(*args, **kw),
            lambda name=name, args=args, kw=kw: dense_plain(name)(*args,
                                                                  **kw),
            name, DENSE_COMPARE[name],
            lambda out, name=name, args=args, kw=kw: dense_bound(
                name, args, kw, out),
            lambda name=name, args=args, kw=kw: dense_counted_bound(
                name, args, kw))
    a = inspect.signature(dense_plain("dense_closest")).bind(
        *rec["dense_closest"]["args"],
        **rec["dense_closest"]["kw"]).arguments
    rvis = a["visibility"]
    kinds = sorted(int(x) for x in torch.unique(rvis).cpu())
    log(f"[main-path] recorded K1 closest input ({label}): visibility values "
        f"{kinds}, lane shares "
        f"{[round(float((rvis == k).float().mean()), 4) for k in kinds]}")
    assert len(kinds) > 1, "the recorded K1 call holds no bounce rays"
    mt = (*mt_packets(a["tri_verts"], a["prim_object"]), a["o"], a["d"],
          a["tmin"], a["tmax"])
    cases[f"K1 mt render rays ({label})"] = (
        lambda: wrapper("dense_mt")(*mt), lambda: dense_plain("dense_mt")(*mt),
        "dense_mt", compare_equal,
        lambda out: dense_bound("dense_mt", mt, {}, out))
    return timed_cases(cases, n, card)


def compare_dual_walk(name, ref, got):
    """K7: blocked masks equal everywhere; the closest ray visits K2's
    clusters in K2's order, so its hit equals the plain walk's to the bit
    on every lane, ties included. Returns the max |t| error (0)."""
    (rhit, rblk), (ghit, gblk) = ref, got
    assert torch.equal(rblk, gblk), f"{name}: blocked masks differ"
    compare_equal(name, rhit, ghit)
    log(f"[kernels] {name}: blocked equal "
        f"({float(gblk.float().mean()):.4f} blocked)")
    return 0.0


def dual_bound(args, out, instances=False):
    """(bound ms, bound_by) of one K7 call. Bytes: tables, both rays and
    results once. Operations: each ray with a non-empty window tests every
    cluster box once; the closest ray tests the triangles of each cluster
    it enters before its final t, the any-hit ray one triangle where it is
    blocked and else those of every cluster it enters; with instance rows
    each ray a transform (XFORM_OPS) at each cluster it tests."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    (cb, ctab, ct, o_c, d_c, tmin_c, tmax_c, vis_c, o_a, d_a, tmin_a, tmax_a,
     vis_a) = args
    hit, blocked = out
    xform = XFORM_OPS if instances else 0
    per = (_prims_per_cluster(ctab, int(ct)) * TRI_OPS + xform)[:, None]
    live_c, live_a = tmax_c > tmin_c, tmax_a > tmin_a
    entry = ci.entry_table(cb, o_c, d_c, tmin_c, tmax_c)
    in_c = (entry < ci.INF) & (entry < hit["t"][None]) & live_c[None]
    row_ops = (in_c.to(torch.float64) * per).sum(0)
    entry = ci.entry_table(cb, o_a, d_a, tmin_a, tmax_a)
    in_a = (entry < ci.INF) & live_a[None]
    row_ops = row_ops + torch.where(blocked, float(TRI_OPS + xform),
                                    (in_a.to(torch.float64) * per).sum(0))
    boxes = float(live_c.sum() + live_a.sum()) * cb.shape[0]
    ops = boxes * SLAB_OPS + float(row_ops.sum())
    return _bound(_nbytes(*args, *hit.values(), blocked), ops)


def _dual_args(rec):
    """A recorded K7 call's 13 table and ray arguments, in order, and its
    has_instances."""
    ra = inspect.signature(wrapper("dual_walk")).bind(*rec["args"],
                                                      **rec["kw"])
    ra.apply_defaults()
    a = ra.arguments
    assert not a["has_motion"] and not a["counts"]
    return tuple(a.values())[:13], bool(a["has_instances"])


def dual_count_phase(label, rec):
    """The counting variant of K7 on a recorded call: outputs equal the
    plain launch's. Prints and returns per lane the mean, p50, p99 and max
    of the rows read, the rows read once for both rays, the passes and the
    boxes tested, beside the earlier design's box tests (a rescan of every
    box for both rays on every visit and one that found nothing:
    (rows + 1) x 2C)."""
    args, inst = _dual_args(rec)
    k7 = wrapper("dual_walk")
    hit, blk = k7(*args, has_instances=inst)
    ghit, gblk, cnt = k7(*args, has_instances=inst, counts=True)
    sync()
    assert torch.equal(blk, gblk) and all(
        torch.equal(hit[k], ghit[k]) for k in hit), \
        f"{label}: the counting variant's outputs differ"
    c = cnt.to(torch.float64)
    st = {}
    for j, key in enumerate(("rows", "shared_rows", "passes", "boxes")):
        x = c[:, j]
        q = torch.quantile(x, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                           device=x.device))
        st[key] = {"mean": float(x.mean()), "p50": float(q[0]),
                   "p99": float(q[1]), "max": float(x.max())}
    ncl = int(args[0].shape[0])
    st["boxes_rescan_design_mean"] = float((c[:, 0] + 1.0).mean()) * 2 * ncl
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())
    log(f"[counts] {label} ({cnt.shape[0]} lanes, C = {ncl}): rows read "
        f"{fmt(st['rows'])}; rows read once for both rays "
        f"{fmt(st['shared_rows'])}; passes {fmt(st['passes'])}; boxes "
        f"tested {fmt(st['boxes'])}; the rescan design's box tests "
        f"{st['boxes_rescan_design_mean']:.2f}")
    return st


def dual_counted_bound(args, instances=False):
    """(bound ms) of the tests a K7 call ran, from its counting variant:
    its box tests (SLAB_OPS each) and, for each row read, the row's
    triangles against one ray, or both where the row served both (the
    table's mean triangles per row), with instance rows a transform for
    each ray a row served; bytes as dual_bound's."""
    hit, blk, cnt = wrapper("dual_walk")(*args, has_instances=instances,
                                         counts=True)
    c = cnt.to(torch.float64)
    per_row = float(_prims_per_cluster(args[1], int(args[2])).mean()) \
        * TRI_OPS + (XFORM_OPS if instances else 0)
    ops = float(c[:, 3].sum()) * SLAB_OPS \
        + float((c[:, 0] + c[:, 1]).sum()) * per_row
    return _bound(_nbytes(*args, *hit.values(), blk), ops)[0]


def check_dual(kg, n_check, rng):
    """K7 against its plain version on the glossy tables: random closest
    rays with mixed per-lane visibility paired with any-hit rays from
    nearby origins toward the lamp, each ray of those pairs switched off in
    turn by an empty window, and camera rays paired with NEE-like shadow
    rays. Returns the max |t| error."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    dev = ds["cluster_table"].device
    tabs = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]))
    side = int(round(n_check ** 0.5))
    k7 = wrapper("dual_walk")
    err = 0.0

    def held(label, *rays):
        args = (*tabs, *rays, torch.full((rays[0].shape[0],), 128,
                                         dtype=torch.int32, device=dev))
        ref, got = ci.intersect_clusters_dual(*args), k7(*args)
        sync()
        return compare_dual_walk(f"dual_walk {label}", ref, got), got

    # random pairs
    o, d = random_rays(n_check, rng, dev)
    n = o.shape[0]
    o_a = (o + 0.05).contiguous()
    to_l = torch.tensor([278.0, 548.0, 279.0], device=dev) - o_a
    dist = to_l.norm(dim=-1)
    d_a = (to_l / dist[:, None]).contiguous()
    tmin = torch.full((n,), 1e-4, device=dev)
    big = torch.full((n,), 1e30, device=dev)
    empty = torch.full((n,), -1.0, device=dev)
    tmax_a = (dist * 0.999).contiguous()
    vis_c = torch.tensor(
        np.array([1, 8, 16], np.int32)[rng.integers(0, 3, n)], device=dev)
    e, (hit, blk) = held("random", o, d, tmin, big, vis_c, o_a, d_a, tmin,
                         tmax_a)
    err = max(err, e)
    assert 0.05 < float(blk.float().mean()) < 0.95
    assert float((hit["prim"] >= 0).float().mean()) > 0.05
    e, (hit, blk) = held("random, any-hit ray off", o, d, tmin, big, vis_c,
                         o_a, d_a, tmin, empty)
    err = max(err, e)
    assert not bool(blk.any()) and bool((hit["prim"] >= 0).any())
    e, (hit, blk) = held("random, closest ray off", o, d, tmin, empty, vis_c,
                         o_a, d_a, tmin, tmax_a)
    err = max(err, e)
    assert bool((hit["prim"] == -1).all()) and torch.equal(hit["t"], empty)
    assert bool(blk.any())

    # camera rays with NEE-like shadow rays
    o, d = camera_rays(kg, side, side, dev)
    n = o.shape[0]
    so, sd, stmin, stmax = shadow_rays(kg, o, d, rng)
    e, (hit, blk) = held(
        "camera", o, d, torch.zeros(n, device=dev),
        torch.full((n,), 1e30, device=dev),
        torch.full((n,), 1, dtype=torch.int32, device=dev), so, sd, stmin,
        stmax)
    assert bool(blk.any()) and not bool(blk.all())
    return {"dual_walk": max(err, e)}


def fused_main_path_checks(kg, side, card, rec, suffix=""):
    """At side x side lanes: K7 on the fused render's recorded input, and
    on the same rays K2 (the closest half) and K3's surface form (the
    any-hit half), the two calls the union walk replaces (instance rows
    where the recorded call has them). Each case's name ends in
    `suffix`."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    args, inst = _dual_args(rec)
    (cb, ctab, ct, o_c, d_c, tmin_c, tmax_c, vis_c, o_a, d_a, tmin_a, tmax_a,
     _vis_a) = args
    n = o_c.shape[0]
    assert n == side * side, "recorded call is not full width"
    kinds = sorted(int(x) for x in torch.unique(vis_c).cpu())
    log(f"[main-path] recorded K7 input: visibility values {kinds}, lane "
        f"shares {[round(float((vis_c == k).float().mean()), 4) for k in kinds]}"
        f"; closest window on {float((tmax_c > tmin_c).float().mean()):.4f}, "
        f"any-hit window on {float((tmax_a > tmin_a).float().mean()):.4f} of "
        "the lanes")
    assert len(kinds) > 1, "the recorded K7 call holds no bounce rays"
    assert bool((tmax_a > tmin_a).any()), "the recorded K7 call tests no shadow"
    k7, k2, k3 = (wrapper(x) for x in ("dual_walk", "cluster_walk",
                                       "occlusion_walk"))
    closest = (cb, ctab, ct, o_c, d_c, tmin_c, tmax_c, vis_c)
    # the unfused step gives a lane without a shadow test the empty window
    # [tmin, tmin]
    occ = (cb, ctab, kg["dscene"]["cluster_boundary"], ct, o_a, d_a, tmin_a,
           tmin_a, torch.maximum(tmax_a, tmin_a), 1, 128, inst)
    kw = {"has_instances": inst}
    cases = {
        "K7 dual render": (
            lambda: k7(*args, **kw),
            lambda: ci.intersect_clusters_dual(*args, **kw),
            "dual_walk", compare_dual_walk,
            lambda out: dual_bound(args, out, inst),
            lambda: dual_counted_bound(args, inst)),
        "K2 closest on K7's render input": (
            lambda: k2(*closest, **kw),
            lambda: ci.intersect_clusters(*closest, **kw),
            "cluster_walk", exactly(compare_hits),
            lambda out: walk_bound(closest, kw, out)),
        "K3 surface on K7's render input": (
            lambda: k3(*occ), lambda: ci.occlusion_clusters(*occ),
            "occlusion_walk", exactly(compare_occlusion),
            lambda out: occlusion_bound(occ, out)),
    }
    return timed_cases({name + suffix: case for name, case in cases.items()},
                       n, card)


def adaptive_checks(dev, card):
    """render_adaptive_device on the glossy scene, unfused and fused: with
    threshold 0 every pixel takes its whole budget and the image is the
    fixed render's; with ADAPTIVE_THRESHOLD the loop converges on fewer
    samples and the image mean stays within 1%."""
    from raytracingproject_tpu_torch.app import examples
    from raytracingproject_tpu_torch.session.adaptive import \
        render_adaptive_device
    from raytracingproject_tpu_torch.session.session import render
    size, spp, chunk = ADAPTIVE_SIZE, ADAPTIVE_SPP, ADAPTIVE_CHUNK
    scene = examples.cornell_box(size, size, spp=spp, spheres="glossy")
    scene.device_update()
    fixed = float(render(scene, spp, chunk=16, device=dev,
                         kg=scene.make_kernel_globals(dev))
                  .astype(np.float64).mean())
    recorded = None
    for fused in (False, True):
        kg = scene.make_kernel_globals(dev)
        if fused:
            kg.update(examples.GLOSSY_FUSED)
        for thr in (0.0, ADAPTIVE_THRESHOLD):
            names = (("dual_walk",) if fused
                     else ("cluster_walk", "occlusion_walk"))
            with record_calls(names, RECORD_CALL) as rec:
                reset_launches()
                t0 = time.perf_counter()
                L, _A, counts, st = render_adaptive_device(
                    kg, size, size, spp, threshold=thr, chunk=chunk)
                sync()
                dt = time.perf_counter() - t0
            if not fused and thr > 0.0:
                recorded = rec
            ran = {k: launches_of(k) for k in ("dual_walk", "cluster_walk",
                                               "occlusion_walk")}
            mean = float((L.astype(np.float64) / counts[:, None]).mean())
            rel = abs(mean / fixed - 1.0)
            log(f"[adaptive] glossy {size}x{size}, budget {spp}, chunk "
                f"{chunk}, threshold {thr}, {'fused' if fused else 'unfused'}"
                f": {dt:.3f} s, {st['samples_rendered'] / dt / 1e6:.4f} "
                f"Msamples/s on {card}; {st['dispatches']} rounds, "
                f"{st['samples_rendered']} of {st['samples_nominal']} "
                f"samples, counts {st['min_samples']}..{st['max_samples']}, "
                f"mean {mean:.8f} (fixed render {fixed:.8f}, rel {rel:.2e}); "
                f"launches {ran}")
            assert np.isfinite(L).all() and st["converged"] \
                and st["n_active"] == 0
            if fused:
                assert ran["dual_walk"] > 0 and ran["cluster_walk"] == 0 \
                    and ran["occlusion_walk"] == 0
            else:
                assert ran["dual_walk"] == 0 and ran["cluster_walk"] > 0 \
                    and ran["occlusion_walk"] > 0
            if thr == 0.0:
                assert (counts == spp).all() and rel <= 0.005
            else:
                assert st["samples_rendered"] < st["samples_nominal"]
                assert rel <= 0.01
    # the unfused stopping run's recorded K2 and K3 calls, held to the bit
    errs = {}
    for name, compare in (("cluster_walk", exactly(compare_hits)),
                          ("occlusion_walk", exactly(compare_occlusion))):
        assert "args" in recorded[name], f"adaptive: no {name} call recorded"
        kern, plain, _which, held, _bound = _recorded_case(
            name, recorded[name], compare)
        got, ref = kern(), plain()
        sync()
        errs[name] = held(f"{name} adaptive render @ "
                          f"{_positional(name, recorded[name])[4].shape[0]}",
                          ref, got)
    return errs


def cap_checks(dev, rng, card, n=N_CHECK):
    """A single-level table at the JAX package's cap (640 clusters of 15
    random triangles on a 9^3 grid) through the integrator's dispatch: K4
    answers the closest hit and K3 the occlusion walk (K2 is not
    launched), each held against its plain version on n random rays from
    around the grid (K3 to the bit, K4 to the bit off exact-t ties and to
    its scan-order mirror on every lane) and timed; K4's counting variant
    is held to the queue-order mirror. Returns (times, errors, counts)."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    from raytracingproject_tpu_torch.ops import integrator as integ
    c, ct = CAP_CLUSTERS, 15
    cb, ctab, cbd = module("tile_walk").grid_tables(c, ct, rng, dev)
    kg = {"dscene": {"cluster_bounds": cb, "cluster_table": ctab,
                     "cluster_boundary": cbd},
          "cluster_tris": ct, "use_brute": False}
    assert integ._closest_walk_name(kg) == "tile_walk"
    assert integ._use_occlusion_walk(kg)
    span = 30.0 * 9
    o, d = random_rays(n, rng, dev, (-0.25 * span,) * 3, (1.25 * span,) * 3)
    tmin = torch.full((n,), 1e-4, device=dev)
    tmaxc = torch.tensor(rng.uniform(10, 2 * span, n).astype(np.float32),
                         device=dev)
    tmaxa = torch.tensor(np.where(rng.uniform(size=n) < 0.5,
                                  rng.uniform(10, span, n), 1e30)
                         .astype(np.float32), device=dev)
    vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
    reset_launches()
    hit = integ._scene_intersect_tris(kg, o, d, tmin, tmaxc, vis)
    occ = integ._occlusion(kg, o, d, tmin, tmaxc, tmaxa)
    sync()
    ran = {k: launches_of(k) for k in ("cluster_walk", "tile_walk",
                                       "occlusion_walk")}
    log(f"[cap] {c} clusters x {ct} triangles through the dispatch: "
        f"launches {ran}")
    assert ran == {"cluster_walk": 0, "tile_walk": 1, "occlusion_walk": 1}
    walk = (cb, ctab, ct, o, d, tmin, tmaxc, vis)
    oargs = (cb, ctab, cbd, ct, o, d, tmin, tmaxc, tmaxa, 1, 128)
    in_order = in_scan_order(compare_hits, "tile_walk", walk, False)
    errs = {"tile_walk": in_order(f"tile_walk closest @ {c} clusters",
                                  ci.intersect_clusters(*walk), hit),
            "occlusion_walk": exactly(compare_occlusion)(
                f"occlusion_walk dual @ {c} clusters",
                ci.occlusion_clusters(*oargs), occ)}
    counts = {"640 clusters": order_count_phase(
        f"K4 closest, {c} clusters", "tile_walk", walk, False)}
    k3, k4 = wrapper("occlusion_walk"), wrapper("tile_walk")
    cases = {
        "K4 closest at the cap": (
            lambda: k4(*walk), lambda: ci.intersect_clusters(*walk),
            "tile_walk", in_order, lambda out: walk_bound(walk, {}, out)),
        "K3 dual at the cap": (
            lambda: k3(*oargs), lambda: ci.occlusion_clusters(*oargs),
            "occlusion_walk", exactly(compare_occlusion),
            lambda out: occlusion_bound(oargs, out)),
    }
    times, e = timed_cases(cases, n, card)
    merge(errs, e)
    return times, errs, counts


def k6_cap_checks(dev, rng, card, n=N_CHECK):
    """K6 on a synthetic two-level table at the JAX package's caps
    (K6_CAP: 512 superclusters of 16 clusters of 38 random triangles,
    each supercluster an instance; ops/onehot2_walk.py grid_tables2) and
    n random rays from around it, closest and any hit: the counting
    variant held to the queue-order mirror, the kernel to its plain
    version (t, u, v to the bit off exact-t ties) and to its scan-order
    mirror on every lane, and timed. Returns (times, errors, counts)."""
    sc, g, ct = K6_CAP
    scb, cb, ctab = module("onehot2_walk").grid_tables2(sc, g, ct, rng, dev)
    kg = {"dscene": {"sc_bounds": scb, "cluster_bounds": cb,
                     "cluster_table": ctab},
          "cluster_tris": ct, "sc_gmax": g, "has_instances": True}
    span = 100.0 * round(sc ** (1.0 / 3.0))
    o, d = random_rays(n, rng, dev, (-0.25 * span,) * 3, (1.25 * span,) * 3)
    tmin = torch.full((n,), 1e-4, device=dev)
    tmaxc = torch.tensor(rng.uniform(10, 2 * span, n).astype(np.float32),
                         device=dev)
    tmaxa = torch.tensor(np.where(rng.uniform(size=n) < 0.5,
                                  rng.uniform(10, span, n), 1e30)
                         .astype(np.float32), device=dev)
    vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
    log(f"[cap] K6: {sc} superclusters x {g} clusters x {ct} triangles, "
        f"{ctab.numel() * 4 / 1e6:.1f} MB of rows")
    counts, cases = {}, {}
    for mode, tmax, any_hit, compare in (
            ("closest", tmaxc, False, compare_hits),
            ("any-hit", tmaxa, True, compare_any_hit)):
        args = (o, d, tmin, tmax, vis)
        counts[f"{sc} superclusters ({mode})"] = order_count_phase(
            f"K6 {mode}, {sc} superclusters", "onehot2_walk",
            k5_args(kg, *args), any_hit)
        cases[f"K6 {mode} at {sc} superclusters"] = (
            lambda a=args, h=any_hit: k5_call(kg, *a, h, "onehot2_walk"),
            lambda a=args, h=any_hit: k5_call(kg, *a, h, None),
            "onehot2_walk",
            in_scan_order(compare, "onehot2_walk", k5_args(kg, *args),
                          any_hit),
            lambda out, a=args, h=any_hit: cluster2_bound(kg, a, h, out))
    times, errs = timed_cases(cases, n, card)
    return times, errs, counts


def dof_camera_rays(kg, rng):
    """Lens-and-motion camera rays (ops/camera.py camera_sample_ray), one
    per pixel of kg's film at a random point of the pixel, with random
    lens and shutter samples."""
    from raytracingproject_tpu_torch.ops import camera as cam_ops
    cam = kg["cam"]
    w, h = int(cam["width"]), int(cam["height"])
    dev = kg["filter_table"].device
    yy, xx = np.mgrid[0:h, 0:w]
    u = rng.uniform(size=(5, w * h))
    lane = [torch.tensor(a.astype(np.float32), device=dev)
            for a in (xx.reshape(-1) + u[0], yy.reshape(-1) + u[1], *u[2:])]
    ray = cam_ops.camera_sample_ray(cam, *lane)
    return ray["o"].contiguous(), ray["d"].contiguous()


def check_dof_walks(kg, rng):
    """K2 closest (to the bit) and any hit (masks) and K3's surface form
    (to the bit) against their plain versions on the dof tables: 65,536
    lens-and-motion camera rays and NEE shadow rays from their first
    hits."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    cb, ct_, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    ctris = int(kg["cluster_tris"])
    o, d = dof_camera_rays(kg, rng)
    n = o.shape[0]
    spread = (o.max(0).values - o.min(0).values).cpu().numpy()
    log(f"[kernels] dof camera rays: {n} lanes, origins spread "
        f"{np.round(spread, 3).tolist()} (aperture 12, shutter shift 25)")
    assert spread[0] > 25.0, "the camera rays leave one point"
    zeros = torch.zeros(n, device=o.device)
    cam = (cb, ct_, ctris, o, d, zeros, torch.full((n,), 1e30,
                                                   device=o.device),
           torch.full((n,), 1, dtype=torch.int32, device=o.device))
    so, sd, stmin, stmax = shadow_rays(kg, o, d, rng)
    shadow = (cb, ct_, ctris, so, sd, stmin, stmax,
              torch.full((n,), 128, dtype=torch.int32, device=o.device))
    errs = {"cluster_walk": 0.0}
    for label, args, any_hit in (("camera closest", cam, False),
                                 ("camera any-hit", cam, True),
                                 ("shadow any-hit", shadow, True)):
        ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit)
        got = wrapper("cluster_walk")(*args, shadow_any_hit=any_hit)
        sync()
        compare = compare_any_hit if any_hit else exactly(compare_hits)
        errs["cluster_walk"] = max(errs["cluster_walk"], compare(
            f"cluster_walk {label} dof", ref, got))
    occ = (cb, ct_, cbd, ctris, so, sd, stmin, stmin, stmax, 1, 128)
    ref = ci.occlusion_clusters(*occ)
    got = wrapper("occlusion_walk")(*occ)
    sync()
    errs["occlusion_walk"] = exactly(compare_occlusion)(
        "occlusion_walk surface shadow dof", ref, got)
    return errs


def dof_fixed_render(kg, card):
    """Phase 34 (a): the fixed render of the CLI's example:dof_motion
    scene, compiled into kg, through session.render_fixed (the CLI itself
    renders the scene adaptively, as the scene declares). Returns
    (launches, stats, image mean)."""
    from raytracingproject_tpu_torch.session.session import render_fixed
    t1 = time.perf_counter()
    reset_launches()
    img = render_fixed(kg, DOF_SPP, DOF_CHUNK)
    sync()
    t2 = time.perf_counter()
    launches = {name: launches_of(name) for name in WRAPPERS}
    mean = float(img.astype(np.float64).mean())
    rel = abs(mean / JAX_MEAN_DOF_256 - 1.0)
    st = {"render_s": t2 - t1,
          "msamples_per_s": DOF_SIZE * DOF_SIZE * DOF_SPP / (t2 - t1) / 1e6}
    log(f"[render] dof_motion fixed {DOF_SIZE}x{DOF_SIZE}x{DOF_SPP} chunk "
        f"{DOF_CHUNK}: {st['render_s']:.3f} s, {st['msamples_per_s']:.4f} "
        f"Msamples/s on {card}; mean "
        f"{mean:.8f} (JAX package {JAX_MEAN_DOF_256:.8f}, rel {rel:.2e}); "
        f"launches { {k: v for k, v in launches.items() if v} }")
    assert img.shape == (DOF_SIZE, DOF_SIZE, 3) and np.isfinite(img).all()
    assert rel <= 0.005, "dof fixed render: mean off the JAX package's"
    return launches, st, mean


def dof_device_adaptive(kg, card, fixed_mean):
    """Phase 34 (c): render_adaptive_device under bench.py
    bench_adaptive's protocol (lanes W * H, min_samples 16, chunk
    min_samples * W * H / lanes); returns (stats, wall s)."""
    from raytracingproject_tpu_torch.session.adaptive import \
        render_adaptive_device
    lanes = DOF_SIZE * DOF_SIZE
    walls = []
    t0 = time.perf_counter()
    L, _A, counts, st = render_adaptive_device(
        kg, DOF_SIZE, DOF_SIZE, DOF_SPP, threshold=DOF_THRESHOLD,
        min_samples=DOF_MIN_SAMPLES,
        chunk=DOF_MIN_SAMPLES * DOF_SIZE * DOF_SIZE // lanes, lanes=lanes,
        on_dispatch=walls.append)
    sync()
    wall = time.perf_counter() - t0
    img = L.astype(np.float64) / np.maximum(counts, 1)[:, None]
    mean = float(img.mean())
    log(f"[adaptive] dof_motion render_adaptive_device {DOF_SIZE}x"
        f"{DOF_SIZE}, budget {DOF_SPP}, min_samples {DOF_MIN_SAMPLES}, "
        f"threshold {DOF_THRESHOLD}: {wall:.3f} s, "
        f"{st['samples_nominal'] / wall / 1e6:.4f} Msamples/s (nominal "
        f"budget over the wall time) on {card}; {st['dispatches']} rounds "
        f"({', '.join(f'{w:.3f}' for w in walls)} s), "
        f"{st['samples_rendered']} of {st['samples_nominal']} samples, "
        f"counts {st['min_samples']}..{st['max_samples']}; mean {mean:.8f} "
        f"(fixed {fixed_mean:.8f}, rel {abs(mean / fixed_mean - 1):.2e}; "
        f"JAX package rel {abs(mean / JAX_MEAN_DOF_256 - 1):.2e})")
    assert np.isfinite(img).all() and st["converged"]
    assert st["samples_rendered"] < st["samples_nominal"]
    assert abs(mean / fixed_mean - 1.0) <= 0.01
    assert abs(mean / JAX_MEAN_DOF_256 - 1.0) <= 0.01
    return st, wall


def dof_fixed_vs_adaptive(dev, card, kg):
    """Phase 35: the fixed render, the CLI's adaptive render and
    render_adaptive_device, DOF_RENDERS timed renders each at
    DOF_TIMED_SPP, in turns (all three are warm from phase 34's renders of
    the same kernel globals); Msamples/s counts the nominal budget over
    the wall time. Returns {driver: [Msamples/s]}."""
    from raytracingproject_tpu_torch.app import cli
    from raytracingproject_tpu_torch.session.adaptive import \
        render_adaptive_device
    from raytracingproject_tpu_torch.session.session import (
        render, render_fixed)
    scene, _flags = cli.load_scene("example:dof_motion")
    nominal = DOF_SIZE * DOF_SIZE * DOF_TIMED_SPP
    drivers = {
        "fixed": lambda: render_fixed(kg, DOF_TIMED_SPP, DOF_CHUNK),
        "session adaptive": lambda: render(scene, DOF_TIMED_SPP,
                                           chunk=DOF_CHUNK, device=dev,
                                           kg=kg),
        "device adaptive": lambda: render_adaptive_device(
            kg, DOF_SIZE, DOF_SIZE, DOF_TIMED_SPP, threshold=DOF_THRESHOLD,
            min_samples=DOF_MIN_SAMPLES, chunk=DOF_MIN_SAMPLES,
            lanes=DOF_SIZE * DOF_SIZE)}
    rates = {k: [] for k in drivers}
    for _ in range(DOF_RENDERS):
        for name, fn in drivers.items():
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
            rates[name].append(nominal / wall / 1e6)
    for name, r in rates.items():
        log(f"[render] dof_motion {name} at {DOF_TIMED_SPP} spp: "
            f"{np.median(r):.4f} Msamples/s (median of {DOF_RENDERS}, warm "
            f"from phase 34, {min(r):.4f}-{max(r):.4f}; nominal budget over "
            f"the wall time) on {card}")
    return rates


def dof_main_path_checks(kg, card, rec):
    """Phase 35: K2 closest and K3's surface form held against their plain
    versions on the dof render's recorded inputs (to the bit) and
    timed."""
    n = rec["cluster_walk"]["args"][4].shape[0]
    kinds, shares = _lane_visibility("cluster_walk", rec["cluster_walk"])
    log(f"[main-path] recorded dof K2 input: visibility values {kinds}, "
        f"lane shares {shares}")
    assert len(kinds) > 1, "the recorded K2 call holds no bounce rays"
    cases = {
        "K2 closest dof render": _recorded_case(
            "cluster_walk", rec["cluster_walk"], exactly(compare_hits)),
        "K3 surface dof render": _recorded_case(
            "occlusion_walk", rec["occlusion_walk"],
            exactly(compare_occlusion)),
    }
    return timed_cases(cases, n, card)


def check_single_level(kg, rng, walk, label, instances=False):
    """On a real scene's single-level tables (flattened, or with instance
    rows where instances=True): K2 (walk="cluster_walk") or K4
    ("tile_walk"), closest and any hit, on 65,536 random rays from inside
    the scene's bounds and 65,536 camera rays, and K3's surface form on
    sun shadow rays from their first hits, each against its plain
    version; with instance rows also K3's dual form on the random and
    camera rays with a seeded random boundary table. K2's closest hit and
    K3 equal to the bit, K4's t, u, v to the bit off exact-t ties and
    every output equal to its scan-order mirror's on every lane, ties
    included; any-hit masks equal. Returns max |t| error per kernel."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    cb, ct_, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    ctris = int(kg["cluster_tris"])
    dev = cb.device
    side = int(round(N_CHECK ** 0.5))
    lo, hi = scene_box(kg)
    errs = {walk: 0.0, "occlusion_walk": 0.0}
    kw = {"has_instances": True} if instances else {}
    for rays, (o, d), tmin0 in (
            ("random", random_rays(N_CHECK, rng, dev, lo, hi), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        args = (cb, ct_, ctris, o, d, torch.full((n,), tmin0, device=dev),
                torch.full((n,), 1e30, device=dev),
                torch.full((n,), 1, dtype=torch.int32, device=dev))
        for any_hit in (False, True):
            ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit, **kw)
            got = wrapper(walk)(*args, shadow_any_hit=any_hit, **kw)
            sync()
            name = (f"{walk} {'any-hit' if any_hit else 'closest'} {rays} "
                    f"{label}")
            if walk == "tile_walk":
                e = in_scan_order(compare_walk, walk, args, any_hit,
                                  instances)(name, ref, got, any_hit)
            elif any_hit:
                e = compare_any_hit(name, ref, got)
            else:
                e = exactly(compare_hits)(name, ref, got)
            errs[walk] = max(errs[walk], e)
        so, sd, stmin, stmax = sun_shadow_rays(
            kg, o, d, rng, hit=ci.intersect_clusters(*args, **kw))
        forms = [("surface sun shadow", (cb, ct_, cbd, ctris, so, sd, stmin,
                                         stmin, stmax, 1, 128, instances))]
        if instances:
            planted = torch.tensor(
                rng.integers(0, 2, cbd.shape).astype(np.float32), device=dev)
            tmaxc, tmaxa = (torch.tensor(a.astype(np.float32), device=dev)
                            for a in (rng.uniform(1, 40, n), np.where(
                                rng.uniform(size=n) < 0.5,
                                rng.uniform(1, 40, n), 1e30)))
            forms.append(("planted dual", (cb, ct_, planted, ctris, o, d,
                                           args[5], tmaxc, tmaxa, 1, 128,
                                           True)))
        for form, occ in forms:
            ref = ci.occlusion_clusters(*occ)
            got = wrapper("occlusion_walk")(*occ)
            sync()
            errs["occlusion_walk"] = max(errs["occlusion_walk"], exactly(
                lambda *a: compare_occlusion(
                    *a, need_boundary=form != "surface sun shadow"))(
                    f"occlusion_walk {form} {rays} {label}", ref, got))
    return errs


def textured_shadow_rays(kg, o, d, rng):
    """Sun shadow rays from K2's closest hits of o, d (single-level
    tables)."""
    ds = kg["dscene"]
    n = o.shape[0]
    hit = wrapper("cluster_walk")(
        ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
        o, d, torch.zeros(n, device=o.device),
        torch.full((n,), 1e30, device=o.device),
        torch.full((n,), 1, dtype=torch.int32, device=o.device))
    return sun_shadow_rays(kg, o, d, rng, hit=hit)


def timed_compile(scene, dev):
    """scene's host compile: (kernel globals, compile s, s in the BVH
    builder)."""
    from raytracingproject_tpu_torch import native
    orig, spent = native.build_bvh_native, []

    def timed(*a, **kw):
        t = time.perf_counter()
        out = orig(*a, **kw)
        spent.append(time.perf_counter() - t)
        return out

    native.build_bvh_native = timed
    try:
        t0 = time.perf_counter()
        scene.device_update()
        kg = scene.make_kernel_globals(dev)
        sync()
        compile_s = time.perf_counter() - t0
    finally:
        native.build_bvh_native = orig
    return kg, compile_s, sum(spent)


def textured_main_path_checks(kg, card, rec, counts):
    """Phase 39: the counting variants of K2 and K3 on the textured
    render's recorded inputs, their rows and boxes printed beside
    glossy's; then K2 and K3 held against their plain versions at 65,536
    lanes (the recorded inputs to the bit, camera rays, sun shadow rays)
    and timed."""
    for name, label in (("cluster_walk", "K2 closest"),
                        ("occlusion_walk", "K3 surface")):
        counts[name]["textured_instanced render"] = count_phase(
            f"{label}, textured_instanced render", name, rec[name])
        g = counts[name]["glossy render"]
        x = counts[name]["textured_instanced render"]
        log(f"[counts] {label.split()[0]} rows per lane: textured_instanced "
            f"{x['rows']['mean']:.2f}, glossy {g['rows']['mean']:.2f}; "
            f"boxes per lane: textured_instanced {x['boxes']['mean']:.2f}, "
            f"glossy {g['boxes']['mean']:.2f}")
    return glossy_main_path_checks(
        kg, TEX_SIZE, np.random.default_rng(SEED + 36), card, rec,
        shadows=textured_shadow_rays, suffix=" (textured_instanced)")


def grid5_render(card, scene, kg, compile_s):
    """Phase 41: instanced_scene(grid=5) at GRID5_SIZE^2 x GRID5_SPP, chunks
    of GRID5_CHUNK, through session.render on the compiled kg; K4 and K3
    launched and no other walk, their third calls copied."""
    from raytracingproject_tpu_torch.session.session import render

    def run():
        t0 = time.perf_counter()
        img = render(scene, GRID5_SPP, chunk=GRID5_CHUNK,
                     device=kg["filter_table"].device, kg=kg)
        sync()
        wall = time.perf_counter() - t0
        return img, {"render_s": wall, "compile_s": compile_s,
                     "msamples_per_s": GRID5_SIZE * GRID5_SIZE * GRID5_SPP
                     / wall / 1e6}

    launches, rec, st = path_render(
        card, "instanced_scene(grid=5)", GRID5_SIZE, GRID5_SPP, GRID5_CHUNK,
        JAX_MEAN_TEX5_128, 0.005, ("tile_walk", "occlusion_walk"), run)
    assert {k for k, v in launches.items() if v} == {
        "tile_walk", "occlusion_walk"}, "grid=5: another walk launched"
    return launches, rec, st


def grid5_main_path_checks(kg, card, rec, cap_times):
    """Phase 42: K4 (to the bit off exact-t ties, and to its scan-order
    mirror on every lane) and K3 (to the bit) held against their plain
    versions and timed on the grid=5 render's recorded inputs, and K4 on
    65,536 camera rays; printed beside the 640-cluster table of phase
    31."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    rk4 = _positional("tile_walk", rec["tile_walk"])
    n = rk4[3].shape[0]
    kinds, shares = _lane_visibility("tile_walk", rec["tile_walk"])
    log(f"[main-path] recorded K4 input (grid=5): visibility values {kinds},"
        f" lane shares {shares}")
    assert len(kinds) > 1, "the recorded K4 call holds no bounce rays"
    times, errs = timed_cases({
        "K4 closest render (grid=5)": _recorded_case(
            "tile_walk", rec["tile_walk"],
            in_scan_order(compare_hits, "tile_walk", rk4[:8], rk4[8])),
        "K3 surface render (grid=5)": _recorded_case(
            "occlusion_walk", rec["occlusion_walk"],
            exactly(compare_occlusion)),
    }, n, card)
    side = int(round(N_CHECK ** 0.5))
    o, d = camera_rays(kg, side, side, ds["cluster_bounds"].device)
    m = o.shape[0]
    cam = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
           o, d, torch.zeros(m, device=o.device),
           torch.full((m,), 1e30, device=o.device),
           torch.full((m,), 1, dtype=torch.int32, device=o.device))
    t2, e = timed_cases({"K4 closest camera (grid=5)": (
        lambda: wrapper("tile_walk")(*cam),
        lambda: ci.intersect_clusters(*cam), "tile_walk",
        in_scan_order(compare_hits, "tile_walk", cam, False),
        lambda out: walk_bound(cam, {}, out))}, m, card)
    times.update(t2)
    merge(errs, e)
    c = int(ds["cluster_bounds"].shape[0])
    for new, cap in (("K4 closest camera (grid=5)", "K4 closest at the cap"),
                     ("K4 closest render (grid=5)", "K4 closest at the cap"),
                     ("K3 surface render (grid=5)", "K3 dual at the cap")):
        a, b = times[new], cap_times[cap]
        log(f"[time] {new}, {c} clusters, {a['lanes']} lanes: "
            f"{a['ms']:.4f} ms (bound {a['bound_ms']:.5f}); beside "
            f"{cap}, {CAP_CLUSTERS} synthetic clusters, {b['lanes']} "
            f"lanes: {b['ms']:.4f} ms (bound {b['bound_ms']:.5f}) ({card})")
    return times, errs


def instanced_compile(spec, dev, prims, clusters, ct, walk):
    """Phases 43 and 47: the host compile of an instanced example through
    the CLI's scene loader: its packed prims, clusters x triangles in one
    single-level table with instance rows, and the dispatch (`walk` for
    every closest hit, K3 for every shadow test)."""
    from raytracingproject_tpu_torch.app import cli
    from raytracingproject_tpu_torch.ops import integrator as integ
    scene, flags = cli.load_scene(spec)
    assert not flags
    kg, compile_s, bvh_s = timed_compile(scene, dev)
    ds = kg["dscene"]
    log(f"[compile] {spec}: {ds['prim_table'].shape[0]} packed prims, "
        f"{ds['cluster_bounds'].shape[0]} clusters x {kg['cluster_tris']} "
        f"triangles with instance rows, host compile {compile_s:.3f} s, of "
        f"which the C++ BVH builder {bvh_s:.4f} s")
    assert kg["has_instances"] and "sc_bounds" not in ds
    assert not kg["use_brute"] and ds["prim_table"].shape[0] == prims
    assert ds["cluster_bounds"].shape[0] == clusters
    assert kg["cluster_tris"] == ct
    assert integ._closest_walk_name(kg) == walk
    assert integ._use_occlusion_walk(kg)
    return kg


def check_dual_instanced(kg, rng, label):
    """K7 with instance rows against its plain version: 65,536 random
    closest rays from inside the scene's bounds and 65,536 camera rays,
    each paired with the sun shadow ray from its first hit (the empty
    window where it misses), and the random pairs once more with the
    closest ray switched off: blocked equal, the closest hit to the bit
    on every lane. Returns the max |t| error."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    dev = ds["cluster_table"].device
    tabs = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]))
    lo, hi = scene_box(kg)
    side = int(round(N_CHECK ** 0.5))
    err = 0.0
    for rays, (o, d), tmin0 in (
            ("random", random_rays(N_CHECK, rng, dev, lo, hi), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tmin = torch.full((n,), tmin0, device=dev)
        big = torch.full((n,), 1e30, device=dev)
        vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
        hit = ci.intersect_clusters(*tabs, o, d, tmin, big, vis,
                                    has_instances=True)
        shadow = (*sun_shadow_rays(kg, o, d, rng, hit=hit),
                  torch.full((n,), 128, dtype=torch.int32, device=dev))
        pairs = [(rays, big)]
        if rays == "random":
            pairs.append(("random, closest ray off",
                          torch.full((n,), -1.0, device=dev)))
        for name, tmax_c in pairs:
            args = (*tabs, o, d, tmin, tmax_c, vis, *shadow)
            ref = ci.intersect_clusters_dual(*args, has_instances=True)
            got = wrapper("dual_walk")(*args, has_instances=True)
            sync()
            err = max(err, compare_dual_walk(f"dual_walk {name} {label}",
                                             ref, got))
            assert bool(got[1].any()) and not bool(got[1].all())
    return {"dual_walk": err}


def grid6_main_path_checks(kg, card, rec):
    """Phase 46: at the render's width, with instance rows, K4 on the
    grid=6 render's recorded closest-hit input (t, u, v to the bit off
    exact-t ties, every output equal to its scan-order mirror's) and on
    camera rays, and K3's surface form on its recorded input (to the
    bit), held against their plain versions and timed."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    rk4 = _positional("tile_walk", rec["tile_walk"])
    assert rk4[9], "the recorded K4 call has no instance rows"
    assert _positional("occlusion_walk", rec["occlusion_walk"])[11], \
        "the recorded K3 call has no instance rows"
    n = rk4[3].shape[0]
    kinds, shares = _lane_visibility("tile_walk", rec["tile_walk"])
    log(f"[main-path] recorded K4 input (grid=6): visibility values {kinds},"
        f" lane shares {shares}")
    assert len(kinds) > 1, "the recorded K4 call holds no bounce rays"
    o, d = camera_rays(kg, INST_SIZE, INST_SIZE, ds["cluster_bounds"].device)
    cam = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
           o, d, torch.zeros(n, device=o.device),
           torch.full((n,), 1e30, device=o.device),
           torch.full((n,), 1, dtype=torch.int32, device=o.device))
    kw = {"has_instances": True}
    return timed_cases({
        "K4 closest render (grid=6)": _recorded_case(
            "tile_walk", rec["tile_walk"],
            in_scan_order(compare_hits, "tile_walk", rk4[:8], rk4[8], True)),
        "K4 closest camera (grid=6)": (
            lambda: wrapper("tile_walk")(*cam, **kw),
            lambda: ci.intersect_clusters(*cam, **kw), "tile_walk",
            in_scan_order(compare_hits, "tile_walk", cam, False, True),
            lambda out: walk_bound(cam, kw, out)),
        "K3 surface render (grid=6)": _recorded_case(
            "occlusion_walk", rec["occlusion_walk"],
            exactly(compare_occlusion)),
    }, n, card)


def grid5n15_main_path_checks(kg, card, rec, frec):
    """Phase 49: at the render's width, with instance rows, K2's closest
    hit and K3's surface form on the unfused render's recorded inputs (to
    the bit), then K7 on the fused render's recorded input (blocked equal,
    the closest hit to the bit) with K2 and K3 on its rays beside it, each
    held against its plain version and timed."""
    assert _positional("cluster_walk", rec["cluster_walk"])[9], \
        "the recorded K2 call has no instance rows"
    n = rec["cluster_walk"]["args"][4].shape[0]
    kinds, shares = _lane_visibility("cluster_walk", rec["cluster_walk"])
    log(f"[main-path] recorded K2 input (grid=5 nlat=15): visibility values "
        f"{kinds}, lane shares {shares}")
    assert len(kinds) > 1, "the recorded K2 call holds no bounce rays"
    times, errs = timed_cases({
        "K2 closest render (grid=5 nlat=15)": _recorded_case(
            "cluster_walk", rec["cluster_walk"], exactly(compare_hits)),
        "K3 surface render (grid=5 nlat=15)": _recorded_case(
            "occlusion_walk", rec["occlusion_walk"],
            exactly(compare_occlusion)),
    }, n, card)
    t2, e = fused_main_path_checks(kg, INST_SIZE, card, frec,
                                   suffix=" (grid=5 nlat=15)")
    times.update(t2)
    merge(errs, e)
    return times, errs


def deform_compile(spec, dev, static_kg):
    """Phases 50 and 54: the host compile of a deforming example through
    the CLI's scene loader, its deform statics and dispatch, and the
    static scene it moves (static_kg): the same prims at shutter open."""
    from raytracingproject_tpu_torch.app import cli
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    from raytracingproject_tpu_torch.ops import integrator as integ
    scene, flags = cli.load_scene(spec)
    assert not flags
    kg, compile_s, _bvh_s = timed_compile(scene, dev)
    ds, ss = kg["dscene"], static_kg["dscene"]
    moved = (ds["tri_verts_world_t1"] != ds["tri_verts_world"]) \
        .flatten(1).any(1)
    assert kg["has_deform_motion"] and kg["has_motion"]
    assert torch.equal(ds["tri_verts_world"], ss["tri_verts_world"])
    if kg["cluster_motion"]:
        ct = int(kg["cluster_tris"])
        assert ds["cluster_table"].shape == (179, ci.row_width(ct, True))
        assert ct == 15 and not kg["use_brute"]
        assert ds["cluster_table"].shape[0] == ss["cluster_table"].shape[0]
        assert integ._closest_walk_name(kg) == "cluster_walk"
        assert integ._use_occlusion_walk(kg)
        assert not integ._use_fused_nee({**kg, "fused_nee": True})
        shape = (f"{ds['cluster_bounds'].shape[0]} clusters x {ct} "
                 f"triangles, motion rows of {ds['cluster_table'].shape[1]} "
                 "floats")
    else:
        assert kg["use_brute"] and "cluster_table" not in ds
        assert kg["deform_steps"] == 3
        shape = (f"dense, a path of {kg['deform_steps']} steps "
                 f"({tuple(ds['tri_verts_world_steps'].shape)})")
    log(f"[compile] {spec}: {ds['prim_table'].shape[0]} prims, "
        f"{int(moved.sum())} moving, {shape}, host compile "
        f"{compile_s:.3f} s")
    return kg


def lane_times(n, rng, dev):
    """Seeded uniform shutter times in [0, 1]."""
    return torch.tensor(rng.uniform(0.0, 1.0, n).astype(np.float32),
                        device=dev)


def motion_shadow_rays(kg, o, d, tm, rng):
    """NEE shadow rays from the rays' first hits at their times (the plain
    motion walk) toward the light (the port's own light sampler); lanes
    that miss get the empty window [1e-5, 1e-5]."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    n = o.shape[0]
    hit = ci.intersect_clusters(
        ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
        o, d, torch.zeros(n, device=o.device),
        torch.full((n,), 1e30, device=o.device),
        torch.full((n,), 1, dtype=torch.int32, device=o.device), time=tm,
        has_motion=True)
    return sun_shadow_rays(kg, o, d, rng, hit=hit)


def check_motion_walks(kg, static_kg, rng):
    """Phase 50: on glossy_deform's motion table, K2 (to the bit) and K4
    (t, u, v to the bit off exact-t ties, every output its scan-order
    mirror's) closest and any hit, and K3 in its surface form (NEE
    shadow rays from the rays' first hits) and its dual form (a seeded
    random boundary table), to the bit, on 65,536 random rays from inside
    the scene and 65,536 camera rays, each lane at a seeded time in [0,
    1]; then the time-0 check: every motion mode at time 0 gives the
    static walk's hits over the static glossy table (the same clusters,
    static bounds): masks equal, t, u, v to the bit where the prim
    agrees (K3: every output). Returns max |t| error per kernel."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds, ss = kg["dscene"], static_kg["dscene"]
    cb, ct_, cbd = ds["cluster_bounds"], ds["cluster_table"], \
        ds["cluster_boundary"]
    ctris = int(kg["cluster_tris"])
    dev = cb.device
    side = int(round(N_CHECK ** 0.5))
    lo, hi = scene_box(kg)
    errs = {"cluster_walk": 0.0, "tile_walk": 0.0, "occlusion_walk": 0.0}
    planted = torch.tensor(rng.integers(0, 2, cbd.shape).astype(np.float32),
                           device=dev)
    for rays, (o, d), tmin0 in (
            ("random", random_rays(N_CHECK, rng, dev, lo, hi), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tm = lane_times(n, rng, dev)
        mkw = {"time": tm, "has_motion": True}
        tmin = torch.full((n,), tmin0, device=dev)
        args = (cb, ct_, ctris, o, d, tmin, torch.full((n,), 1e30, device=dev),
                torch.full((n,), 1, dtype=torch.int32, device=dev))
        for any_hit in (False, True):
            ref = ci.intersect_clusters(*args, shadow_any_hit=any_hit, **mkw)
            mode = "any-hit" if any_hit else "closest"
            for walk in ("cluster_walk", "tile_walk"):
                got = wrapper(walk)(*args, shadow_any_hit=any_hit, **mkw)
                sync()
                name = f"{walk} {mode} {rays} glossy_deform (motion rows)"
                if walk == "tile_walk":
                    e = in_scan_order(compare_walk, walk, args, any_hit,
                                      motion=tm)(name, ref, got, any_hit)
                elif any_hit:
                    e = compare_any_hit(name, ref, got)
                else:
                    e = exactly(compare_hits)(name, ref, got)
                errs[walk] = max(errs[walk], e)
        so, sd, stmin, stmax = motion_shadow_rays(kg, o, d, tm, rng)
        tmaxc, tmaxa = (torch.tensor(a.astype(np.float32), device=dev)
                        for a in (rng.uniform(10, 1000, n), np.where(
                            rng.uniform(size=n) < 0.5,
                            rng.uniform(10, 800, n), 1e30)))
        for form, occ in (
                ("surface shadow", (cb, ct_, cbd, ctris, so, sd, stmin,
                                    stmin, stmax, 1, 128)),
                ("planted dual", (cb, ct_, planted, ctris, o, d, tmin,
                                  tmaxc, tmaxa, 1, 128))):
            ref = ci.occlusion_clusters(*occ, **mkw)
            got = wrapper("occlusion_walk")(*occ, **mkw)
            sync()
            errs["occlusion_walk"] = max(errs["occlusion_walk"], exactly(
                lambda *a: compare_occlusion(
                    *a, need_boundary=form != "surface shadow"))(
                    f"occlusion_walk {form} {rays} glossy_deform "
                    "(motion rows)", ref, got))
        # ---- the time-0 check: the static walks over the static table
        zero = {"time": torch.zeros(n, device=dev), "has_motion": True}
        sargs = (ss["cluster_bounds"], ss["cluster_table"], ctris,
                 *args[3:])
        for walk in ("cluster_walk", "tile_walk"):
            for any_hit in (False, True):
                got = wrapper(walk)(*args, shadow_any_hit=any_hit, **zero)
                ref = wrapper(walk)(*sargs, shadow_any_hit=any_hit)
                sync()
                name = (f"{walk} {'any-hit' if any_hit else 'closest'} "
                        f"{rays} glossy_deform at time 0 vs the static "
                        "table")
                if any_hit:
                    compare_any_hit(name, ref, got)
                else:
                    exact_off_ties(compare_hits)(name, ref, got)
        for form, occ in (("surface shadow", (so, sd, stmin, stmin, stmax)),
                          ("dual", (o, d, tmin, tmaxc, tmaxa))):
            got = wrapper("occlusion_walk")(cb, ct_, cbd, ctris, *occ, 1,
                                            128, **zero)
            ref = wrapper("occlusion_walk")(
                ss["cluster_bounds"], ss["cluster_table"],
                ss["cluster_boundary"], ctris, *occ, 1, 128)
            sync()
            exactly(compare_occlusion)(
                f"occlusion_walk {form} {rays} glossy_deform at time 0 vs "
                "the static table", ref, got)
    return errs


def glossy_deform_main_path_checks(kg, card, rec, trec, counts):
    """Phase 53: the counting variants of K2 and K3 on the glossy_deform
    render's recorded inputs and of K4 on the tile render's (its counts
    equal to tile_queue_order's, at the lanes' times), their rows and
    boxes printed beside glossy's; then K2 and K3 (to the bit) and K4 (t,
    u, v to the bit off exact-t ties, every output its scan-order
    mirror's) held against their plain versions on those inputs and
    timed, and K2 on camera rays at seeded times."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    for name, label, r in (("cluster_walk", "K2 closest", rec),
                           ("occlusion_walk", "K3 surface", rec)):
        args = _positional(name, r[name])
        assert args[13 if name == "occlusion_walk" else 11], \
            f"the recorded {label} call has no motion rows"
        counts[name]["glossy_deform render"] = count_phase(
            f"{label}, glossy_deform render (motion rows)", name, r[name])
        g = counts[name]["glossy render"]
        x = counts[name]["glossy_deform render"]
        log(f"[counts] {label.split()[0]} rows per lane: glossy_deform "
            f"{x['rows']['mean']:.2f}, glossy {g['rows']['mean']:.2f}; "
            f"boxes per lane: glossy_deform {x['boxes']['mean']:.2f}, "
            f"glossy {g['boxes']['mean']:.2f}")
    rk4 = _positional("tile_walk", trec["tile_walk"])
    assert rk4[11], "the recorded K4 call has no motion rows"
    counts["tile_walk"]["glossy_deform tile render"] = order_count_phase(
        "K4 closest, glossy_deform tile render (motion rows)", "tile_walk",
        rk4[:8], rk4[8], motion=rk4[10])
    n = rec["cluster_walk"]["args"][4].shape[0]
    kinds, shares = _lane_visibility("cluster_walk", rec["cluster_walk"])
    log(f"[main-path] recorded K2 input (glossy_deform): visibility values "
        f"{kinds}, lane shares {shares}")
    assert len(kinds) > 1, "the recorded K2 call holds no bounce rays"
    ds = kg["dscene"]
    o, d = camera_rays(kg, DEFORM_SIZE, DEFORM_SIZE, ds["cluster_bounds"]
                       .device)
    cam = (ds["cluster_bounds"], ds["cluster_table"], int(kg["cluster_tris"]),
           o, d, torch.zeros(n, device=o.device),
           torch.full((n,), 1e30, device=o.device),
           torch.full((n,), 1, dtype=torch.int32, device=o.device))
    mkw = {"time": lane_times(n, np.random.default_rng(SEED + 53), o.device),
           "has_motion": True}
    return timed_cases({
        "K2 closest render (glossy_deform)": _recorded_case(
            "cluster_walk", rec["cluster_walk"], exactly(compare_hits)),
        "K2 closest camera (glossy_deform)": (
            lambda: wrapper("cluster_walk")(*cam, **mkw),
            lambda: ci.intersect_clusters(*cam, **mkw), "cluster_walk",
            exactly(compare_hits), lambda out: walk_bound(cam, mkw, out)),
        "K3 surface render (glossy_deform)": _recorded_case(
            "occlusion_walk", rec["occlusion_walk"],
            exactly(compare_occlusion)),
        "K4 closest render (glossy_deform tile)": _recorded_case(
            "tile_walk", trec["tile_walk"],
            in_scan_order(compare_hits, "tile_walk", rk4[:8], rk4[8],
                          motion=rk4[10])),
    }, n, card)


def check_deform_dense(kg, static_kg, rng):
    """Phase 54: K1's deform modes (closest, any, dual) against their
    plain versions on cornell_deform's three-step path and on its last
    step alone (a two-step path), on 65,536 random rays with mixed
    visibility and a tenth of the windows empty, 65,536 camera rays and
    the grazing set, each lane at a seeded time in [0, 1]: every output
    to the bit; the counting variant's kept blocks equal block_keep's
    mirror with the steps (ops/dense_sweep.py kept_blocks) on every lane;
    then the time-0 check: every deform mode at time 0 equal to the
    static sweep of the static box's triangles, to the bit. Returns max
    |t| error per mode."""
    from raytracingproject_tpu_torch.ops import dense_sweep as k1
    ds = kg["dscene"]
    tv, po, ov, bnd = dense_tables(kg, rng)
    stv = static_kg["dscene"]["tri_verts_world"]
    assert torch.equal(stv, tv)
    dev = tv.device
    side = int(round(N_CHECK ** 0.5))
    kinds = np.array([1, 8, 16, 4, 128], np.int32)
    errs = {k: 0.0 for k in ("dense_closest", "dense_any", "dense_dual")}
    o, d = random_rays(N_CHECK, rng, dev)
    ray_sets = [("random", o, d, torch.full((N_CHECK,), 1e-4, device=dev))]
    o, d = camera_rays(kg, side, side, dev)
    ray_sets.append(("camera", o, d, torch.zeros(o.shape[0], device=dev)))
    ray_sets.append(("grazing", *k1.grazing_rays(tv, N_GRAZING, SEED + 54)))
    paths = {"three-step": ds["tri_verts_world_steps"],
             "two-step": ds["tri_verts_world_steps"][-1:].contiguous()}
    for rays, o, d, tmin in ray_sets:
        n = o.shape[0]
        tm = lane_times(n, rng, dev)
        empty = torch.tensor(rng.uniform(size=n) < (
            0.1 if rays == "random" else 0.0), device=dev)
        tmax = torch.where(empty, tmin, 1e30)
        tmax_any = torch.tensor(
            np.where(rng.uniform(size=n) < 0.5, rng.uniform(10, 800, n),
                     1e30).astype(np.float32), device=dev)
        tmax_c = torch.tensor(rng.uniform(10, 1000, n).astype(np.float32),
                              device=dev)
        vis = torch.tensor(kinds[rng.integers(0, 5, n)] if rays != "camera"
                           else np.ones(n, np.int32), device=dev)
        svis = torch.full((n,), 128, dtype=torch.int32, device=dev)
        calls = {
            "dense_closest": (tv, po, o, d, tmin, tmax, vis, ov),
            "dense_any": (tv, po, o, d, tmin, tmax_any, svis, ov),
            "dense_dual": (tv, po, bnd, o, d, tmin, tmax_c, tmax_any, vis,
                           svis, ov),
        }
        for path, steps in paths.items():
            kw = {"tri_verts_t1": steps, "time": tm}
            for name, args in calls.items():
                ref = dense_plain(name)(*args, **kw)
                got = wrapper(name)(*args, **kw)
                sync()
                label = f"{name} cornell_deform {path} {rays}"
                errs[name] = max(errs[name], DENSE_COMPARE[name](
                    label, ref, got))
                if path == "three-step":
                    dense_count_phase(f"K1 {DENSE_MODE[name]} deform, {rays}",
                                      name, {"args": args, "kw": kw})
        zero = {"tri_verts_t1": paths["three-step"],
                "time": torch.zeros(n, device=dev)}
        for name, args in calls.items():
            ref = wrapper(name)(*args)
            got = wrapper(name)(*args, **zero)
            sync()
            DENSE_COMPARE[name](
                f"{name} cornell_deform at time 0 vs the static sweep "
                f"{rays}", ref, got)
    return errs


def deform_dense_main_path_checks(kg, card, rec, counts):
    """Phase 57: K1's counting variant on the cornell_deform render's
    recorded closest and any-hit inputs (kept blocks equal the mirror's,
    with the steps), then each recorded call held against its plain
    version (to the bit) and timed, with the bound of the tests it
    ran."""
    cases = {}
    n = None
    for name in ("dense_closest", "dense_any"):
        r = rec[name]
        a = inspect.signature(dense_plain(name)).bind(*r["args"],
                                                      **r["kw"]).arguments
        assert a.get("tri_verts_t1") is not None and a["time"] is not None, \
            f"the recorded {name} call has no deform path"
        n = a["o"].shape[0]
        counts.setdefault(name, {})["cornell_deform render"] = \
            dense_count_phase(f"K1 {DENSE_MODE[name]}, cornell_deform "
                              "render (deform)", name, r)
        args, kw = r["args"], r["kw"]
        cases[f"K1 {DENSE_MODE[name]} render (cornell_deform)"] = (
            lambda name=name, args=args, kw=kw: wrapper(name)(*args, **kw),
            lambda name=name, args=args, kw=kw: dense_plain(name)(*args,
                                                                  **kw),
            name, DENSE_COMPARE[name],
            lambda out, name=name, args=args, kw=kw: dense_bound(
                name, args, kw, out),
            lambda name=name, args=args, kw=kw: dense_counted_bound(
                name, args, kw))
    return timed_cases(cases, n, card)


def deform_twin(path):
    """(f64 image, f32 image, rmse gate, share gate, unstable pixels) of
    a deforming scene's twin: twice the JAX package's own float32
    render's rmse against its float64 one, and twice its share of pixels
    off by more than 1e-3 or glossy's 0.07%, whichever is larger; the
    unstable pixels (accuracy's `unstable`) are those the twin file
    records, with the JAX package's float32 value of each under another
    compilation."""
    pair = np.load(TWIN_DEFORM[path])
    unstable = tuple(((int(r), int(c)), v) for (r, c), v in zip(
        pair["unstable"], pair["f32_jax_unstable"])) \
        if "unstable" in pair.files else ()
    d32 = pair["f32_jax"] - pair["f64"]
    rmse = float(np.sqrt(np.mean(d32 * d32)))
    frac = float((np.abs(d32).sum(-1) > 1e-3).mean())
    log(f"[accuracy] {path}: the JAX package's f32 render vs the twin: "
        f"rmse {rmse:.3e}, pixels off >1e-3 {frac:.5f}")
    return (pair["f64"], pair["f32_jax"], 2.0 * rmse,
            max(2.0 * frac, TEX_FRAC_GATE), unstable)


def deform_big_compile(dev, static_kg):
    """Phase 58: the host compile of example:glossy_deform_big through
    the CLI's scene loader, its two-level motion tables and dispatch, and
    the static scene it moves (static_kg, glossy_big: the same prims at
    shutter open)."""
    from raytracingproject_tpu_torch.app import cli
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    from raytracingproject_tpu_torch.ops import integrator as integ
    scene, flags = cli.load_scene("example:glossy_deform_big")
    assert not flags
    kg, compile_s, bvh_s = timed_compile(scene, dev)
    ds, ss = kg["dscene"], static_kg["dscene"]
    moved = (ds["tri_verts_world_t1"] != ds["tri_verts_world"]) \
        .flatten(1).any(1)
    ct = int(kg["cluster_tris"])
    assert kg["has_deform_motion"] and kg["cluster_motion"]
    assert not kg["use_brute"] and not kg["has_instances"]
    assert torch.equal(ds["tri_verts_world"], ss["tri_verts_world"])
    assert ct == 64 and int(kg["sc_gmax"]) == 64
    assert ds["sc_bounds"].shape == (25, 8)
    assert ds["cluster_table"].shape == (936, ci.row_width(ct, True))
    assert ss["cluster_table"].shape == (936, ci.row_width(ct))
    assert not integ._use_occlusion_walk(kg)
    assert module("onehot2_walk").fits(kg["sc_gmax"], 25,
                                       ds["cluster_table"].shape[1])
    log(f"[compile] example:glossy_deform_big: {ds['prim_table'].shape[0]} "
        f"prims, {int(moved.sum())} moving, {ds['cluster_bounds'].shape[0]} "
        f"clusters x {ct} triangles in {ds['sc_bounds'].shape[0]} "
        f"superclusters (gmax {kg['sc_gmax']}), motion rows of "
        f"{ds['cluster_table'].shape[1]} floats; host compile "
        f"{compile_s:.3f} s, of which the BVH builder {bvh_s:.4f} s")
    return kg


def _motion2_kw(any_hit, tm):
    return {"shadow_any_hit": any_hit, "time": tm, "has_motion": True}


def check_motion_two_level(kg, static_kg, rng):
    """Phase 58: K5 and K6 with motion rows on glossy_deform_big's tables,
    closest and any hit, on 65,536 random rays from inside the scene and
    65,536 camera rays, and any hit on NEE shadow rays from their first
    hits, each lane at a seeded time in [0, 1]: hit masks equal to the
    plain version's, t, u, v to the bit off exact-t ties (max |dt| 0),
    every output the scan-order mirror's at the lanes' times; then the
    time-0 check: each motion mode at time 0 against the same kernel's
    static walk over glossy_big's static tables (the same clusters,
    static bounds). Returns max |t| error per kernel."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci
    ds = kg["dscene"]
    dev = ds["cluster_table"].device
    side = int(round(N_CHECK ** 0.5))
    lo, hi = scene_box(kg)
    errs = {name: 0.0 for name in TWO_LEVEL}
    for rays, (o, d), tmin0 in (
            ("random", random_rays(N_CHECK, rng, dev, lo, hi), 1e-4),
            ("camera", camera_rays(kg, side, side, dev), 0.0)):
        n = o.shape[0]
        tm = lane_times(n, rng, dev)
        vis = torch.full((n,), 1, dtype=torch.int32, device=dev)
        tmin = torch.full((n,), tmin0, device=dev)
        lanes = (o, d, tmin, torch.full((n,), 1e30, device=dev), vis)
        so, sd, stmin, stmax = motion_shadow_rays(kg, o, d, tm, rng)
        shadow = (so, sd, stmin, stmax,
                  torch.full((n,), 128, dtype=torch.int32, device=dev))
        for label, ray, any_hit in (("closest", lanes, False),
                                    ("any-hit", lanes, True),
                                    ("any-hit shadow", shadow, True)):
            args = k5_args(kg, *ray)
            kw = _motion2_kw(any_hit, tm)
            ref = ci.intersect_clusters(*args[1:4], *args[5:], **kw)
            for name in TWO_LEVEL:
                got = wrapper(name)(*args, **kw)
                sync()
                e = in_scan_order(compare_walk, name, args, any_hit,
                                  motion=tm)(
                    f"{name} {label} {rays} glossy_deform_big (motion rows)",
                    ref, got, any_hit)
                assert e == 0.0, f"{name} {label} {rays}: |dt| {e} off ties"
                errs[name] = max(errs[name], e)
        # ---- the time-0 check: the static walks over the static tables
        zero = torch.zeros(n, device=dev)
        for name in TWO_LEVEL:
            for any_hit in (False, True):
                got = wrapper(name)(*k5_args(kg, *lanes),
                                    **_motion2_kw(any_hit, zero))
                ref = wrapper(name)(*k5_args(static_kg, *lanes),
                                    shadow_any_hit=any_hit)
                sync()
                label = (f"{name} {'any-hit' if any_hit else 'closest'} "
                         f"{rays} glossy_deform_big at time 0 vs the static "
                         "tables")
                if any_hit:
                    compare_any_hit(label, ref, got)
                else:
                    exact_off_ties(compare_hits)(label, ref, got)
    return errs


def _two_level_rec(name, rec):
    """A recorded K5 or K6 call with motion rows: (its ten positional
    arguments, any_hit, the lanes' times)."""
    ra = inspect.signature(wrapper(name)).bind(*rec["args"], **rec["kw"])
    ra.apply_defaults()
    a = ra.arguments
    assert a["has_motion"] and not a["has_instances"], \
        f"the recorded {name} call has no motion rows"
    return (tuple(a[k] for k in ("sc_bounds", "cbounds", "ctable",
                                 "cluster_tris", "gmax", "o", "d", "tmin",
                                 "tmax", "visibility")),
            bool(a["shadow_any_hit"]), a["time"])


def deform_big_main_path_checks(kg, card, rec, orec, counts):
    """Phase 61: the counting variants of K5 (glossy_deform_big render)
    and K6 (its :onehot2 render) on their recorded closest-hit and
    any-hit inputs (counts equal to the queue-order mirrors' at the
    lanes' times); then each held against the plain version (t, u, v to
    the bit off exact-t ties, every output its scan-order mirror's) on
    those inputs and timed, and K5 on K6's closest-hit input beside it."""
    from raytracingproject_tpu_torch.ops import cluster_intersect as ci

    def case(name, args, any_hit, tm):
        kw = _motion2_kw(any_hit, tm)
        compare = in_scan_order(compare_any_hit if any_hit else compare_hits,
                                name, args, any_hit, motion=tm)
        return (lambda: wrapper(name)(*args, **kw),
                lambda: ci.intersect_clusters(*args[1:4], *args[5:], **kw),
                name, compare,
                lambda out: cluster2_bound(kg, args[5:], any_hit, out, tm))

    cases = {}
    for tag, name, r in (("K5", "cluster2_walk", rec),
                         ("K6", "onehot2_walk", orec)):
        cargs, c_any, ctm = _two_level_rec(name, r[name])
        aargs, a_any, atm = _two_level_rec(name, r[name]["any"])
        assert not c_any and a_any
        n = cargs[5].shape[0]
        assert n == DEFORM_SIZE * DEFORM_SIZE, "recorded call not full width"
        kinds = sorted(int(x) for x in torch.unique(cargs[9]).cpu())
        log(f"[main-path] recorded {tag} input (glossy_deform_big): "
            f"visibility values {kinds}")
        assert len(kinds) > 1, f"the recorded {tag} call holds no bounce rays"
        for mode, args, any_hit, tm in (("closest", cargs, False, ctm),
                                        ("any-hit", aargs, True, atm)):
            counts[name][f"glossy_deform_big render ({mode})"] = \
                order_count_phase(f"{tag} {mode}, glossy_deform_big render "
                                  "(motion rows)", name, args, any_hit,
                                  motion=tm)
        cases[f"{tag} closest render (glossy_deform_big)"] = case(
            name, cargs, False, ctm)
        cases[f"{tag} any-hit render (glossy_deform_big)"] = case(
            name, aargs, True, atm)
        if name == "onehot2_walk":
            cases["K5 closest on K6's render input (glossy_deform_big)"] = \
                case("cluster2_walk", cargs, False, ctm)
    return timed_cases(cases, DEFORM_SIZE * DEFORM_SIZE, card)


def merge(errs, new):
    """Keep the largest error per kernel."""
    for k, v in new.items():
        errs[k] = max(errs.get(k, 0.0), v)


def main():
    # ---- 1. environment ----
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from raytracingproject_tpu_torch import kernels
    from raytracingproject_tpu_torch.app import examples
    from raytracingproject_tpu_torch.device import get_device
    dev = get_device("cuda")
    t_start = time.perf_counter()

    def mark(phase):
        log(f"[elapsed] {time.perf_counter() - t_start:.1f} s before {phase}")

    card = card_line()
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, tf32 cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    mark("2. build")
    # ---- 2. build ----
    t0 = time.perf_counter()
    kernels.load()
    log(f"[build] {len(kernels.sources())} sources, built "
        f"{kernels.build_info['built']} in parallel in "
        f"{kernels.build_info['seconds']:.2f} s (load "
        f"{time.perf_counter() - t0:.2f} s)")
    for line in kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") \
                or "entry function" in line:
            log(f"[build] {line.strip()}")
    from raytracingproject_tpu_torch import native
    native.load()
    log(f"[build] BVH builder {native.SOURCE.split('/')[-1]} (g++ "
        f"{' '.join(native.GXX_FLAGS)}): "
        f"{'built' if native.build_info['built'] else 'cached'} in "
        f"{native.build_info['seconds']:.2f} s")
    rng = np.random.default_rng(SEED)

    mark("glossy_nee_mis")
    # ---- glossy_nee_mis: 3. kernel checks; 4. accuracy; 5. full width;
    # 6. main-path shapes ----
    scene = examples.cornell_box(512, 512, spp=64, spheres="glossy")
    scene.device_update()
    kg = scene.make_kernel_globals(dev)
    errs = check_walks(kg, N_CHECK, rng, ("cluster_walk", "tile_walk"),
                       ("surface", "planted"))
    accuracy(dev, "glossy_nee_mis",
             examples.cornell_box(64, 64, spp=128, spheres="glossy"), {},
             5.7e-5, 0.0007)
    g_launch, g_rec, g_st = full_width(
        card, "example:cornell:glossy", 512, 32, JAX_MEAN_512, 0.005,
        ("cluster_walk", "occlusion_walk"))
    counts = {
        "cluster_walk": {"glossy render": count_phase(
            "K2 closest, glossy render", "cluster_walk",
            g_rec["cluster_walk"])},
        "occlusion_walk": {"glossy render": count_phase(
            "K3 surface, glossy render", "occlusion_walk",
            g_rec["occlusion_walk"])}}
    g_times, e = glossy_main_path_checks(kg, 512, rng, card, g_rec)
    merge(errs, e)

    mark("volume_sss")
    # ---- volume_sss: 7. kernel checks; 8. accuracy; 9. full width;
    # 10. main-path shapes ----
    vscene = examples.volume_sss_scene(256, 256, spp=32)
    vscene.device_update()
    vkg = vscene.make_kernel_globals(dev)
    vkg.update(examples.VOLUME_SSS_DISPATCH)
    e = check_walks(vkg, N_CHECK, rng, ("tile_walk",), ("dual",),
                    random_tie_frac=TIE_FRAC_COPLANAR)
    merge(errs, e)
    accuracy(dev, "volume_sss", examples.volume_sss_scene(64, 64, spp=128),
             examples.VOLUME_SSS_DISPATCH, 1.15e-4, 0.0015)
    v_launch, v_rec, v_st = full_width(
        card, "example:volume_sss", 256, 16, JAX_MEAN_VOL_256, 0.01,
        ("tile_walk", "occlusion_walk"))
    counts["occlusion_walk"]["volume_sss render"] = count_phase(
        "K3 dual, volume_sss render", "occlusion_walk",
        v_rec["occlusion_walk"])
    rk4 = _positional("tile_walk", v_rec["tile_walk"])
    counts["tile_walk"] = {"volume_sss render": order_count_phase(
        "K4 closest, volume_sss render", "tile_walk", rk4[:8], rk4[8])}
    v_times, e = volume_main_path_checks(vkg, 256, card, v_rec)
    merge(errs, e)

    mark("big_instanced")
    # ---- big_instanced: 11. kernel checks; 12. accuracy; 13. full width;
    # 14. main-path shapes ----
    bscene = examples.instanced_scene(256, 256, spp=16, grid=8)
    bscene.device_update()
    bkg = bscene.make_kernel_globals(dev)
    assert "sc_bounds" in bkg["dscene"] and bkg["has_instances"]
    merge(errs, check_cluster2(bkg, N_CHECK, rng))
    pair = np.load(TWIN_BIG)
    d32 = pair["f32_jax"] - pair["f64"]
    jax_rmse = float(np.sqrt(np.mean(d32 * d32)))
    jax_frac = float((np.abs(d32).sum(-1) > 1e-3).mean())
    log(f"[accuracy] big_instanced: the JAX package's f32 render vs the "
        f"twin: rmse {jax_rmse:.3e}, pixels off >1e-3 {jax_frac:.5f}")
    accuracy(dev, "big_instanced",
             examples.instanced_scene(64, 64, spp=128, grid=8), {},
             2.0 * jax_rmse, 2.0 * jax_frac, twin=pair["f64"],
             twin_f32=pair["f32_jax"])
    b_launch, b_rec, b_st = full_width(
        card, "example:big_instanced", 256, 16, JAX_MEAN_BIG_256, 0.005,
        ("cluster2_walk",), chunk=8)
    counts["cluster2_walk"] = {}
    b_times, e = big_main_path_checks(bkg, 256, rng, card,
                                      b_rec["cluster2_walk"],
                                      counts=counts["cluster2_walk"])
    merge(errs, e)

    mark("cornell_diffuse")
    # ---- cornell_diffuse: 15. kernel checks; 16. accuracy; 17. full
    # width; 18. main-path shapes ----
    cscene = examples.cornell_box(512, 512, spp=64)
    cscene.device_update()
    ckg = cscene.make_kernel_globals(dev)
    assert ckg["use_brute"] and "cluster_table" not in ckg["dscene"]
    merge(errs, check_dense(ckg, N_CHECK, rng, "cornell"))
    accuracy(dev, "cornell_diffuse", examples.cornell_box(64, 64, spp=128),
             {}, 5.7e-5, 0.0007)
    c_launch, c_rec, c_st = full_width(
        card, "example:cornell", 512, 32, JAX_MEAN_CORNELL_512, 0.005,
        ("dense_closest", "dense_any"), chunk=32)
    for name in ("dense_closest", "dense_any"):
        counts[name] = {"cornell render": dense_count_phase(
            f"K1 {DENSE_MODE[name]}, cornell render", name, c_rec[name])}
    c_times, e = dense_main_path_checks(ckg, "cornell", 512 * 512, card, c_rec)
    merge(errs, e)

    mark("volume_sss, dense dispatch")
    # ---- volume_sss, dense dispatch: 19. kernel checks; 20. accuracy; 21.
    # full width; 22. main-path shapes ----
    dkg = vscene.make_kernel_globals(dev)
    assert dkg["use_brute"]
    merge(errs, check_dense(dkg, N_CHECK, rng, "volume_sss"))
    accuracy(dev, "volume_sss", examples.volume_sss_scene(64, 64, spp=128),
             {}, 1.15e-4, 0.0015)
    d_launch, d_rec, d_st = full_width(
        card, "example:volume_sss:dense", 256, 16, JAX_MEAN_VOL_256, 0.01,
        ("dense_closest", "dense_dual"))
    for name in ("dense_closest", "dense_dual"):
        counts.setdefault(name, {})["volume_sss render"] = dense_count_phase(
            f"K1 {DENSE_MODE[name]}, volume_sss dense render", name,
            d_rec[name])
    d_times, e = dense_main_path_checks(dkg, "volume_sss", 256 * 256, card,
                                        d_rec)
    merge(errs, e)

    mark("big_instanced with pallas_onehot2")
    # ---- big_instanced with pallas_onehot2: 23. kernel checks; 24. full
    # width; 25. main-path shapes ----
    merge(errs, check_cluster2(bkg, N_CHECK, rng, "onehot2_walk"))
    o_launch, o_rec, o_st = full_width(
        card, "example:big_instanced:onehot2", 256, 16, JAX_MEAN_BIG_256,
        0.005, ("onehot2_walk",), chunk=8)
    assert o_launch["cluster2_walk"] == 0
    counts["onehot2_walk"] = {}
    o_times, e = big_main_path_checks(bkg, 256, rng, card,
                                      o_rec["onehot2_walk"], "onehot2_walk",
                                      counts=counts["onehot2_walk"])
    merge(errs, e)
    k6_times, e, k6_counts = k6_cap_checks(dev, rng, card)
    merge(errs, e)
    o_times.update(k6_times)
    counts["onehot2_walk"].update(k6_counts)

    mark("glossy_nee_mis, fused-NEE mode")
    # ---- glossy_nee_mis, fused-NEE mode: 26. kernel checks; 27. accuracy;
    # 28. full width; 29. main-path shapes ----
    merge(errs, check_dual(kg, N_CHECK, rng))
    before = launches_of("dual_walk")
    accuracy(dev, "glossy_nee_mis",
             examples.cornell_box(64, 64, spp=128, spheres="glossy"),
             examples.GLOSSY_FUSED, 5.7e-5, 0.0007)
    assert launches_of("dual_walk") > before, "the fused render ran unfused"
    f_launch, f_rec, f_st = full_width(
        card, "example:cornell:glossy:fused", 512, 32, JAX_MEAN_512, 0.005,
        ("dual_walk",))
    assert f_launch["cluster_walk"] == 0 and f_launch["occlusion_walk"] == 0
    counts["dual_walk"] = {"glossy fused render": dual_count_phase(
        "K7, glossy fused render", f_rec["dual_walk"])}
    f_times, e = fused_main_path_checks(kg, 512, card, f_rec["dual_walk"])
    merge(errs, e)

    mark("30. the adaptive loop")
    # ---- 30. the adaptive loop ----
    merge(errs, adaptive_checks(dev, card))

    mark("31. a single-level table at the cap")
    # ---- 31. a single-level table at the cap ----
    cap_times, e, cap_counts = cap_checks(dev, rng, card)
    merge(errs, e)
    counts["tile_walk"].update(cap_counts)

    mark("dof_motion_adaptive")
    # ---- dof_motion_adaptive: 32. kernel checks; 33. accuracy; 34. full
    # width; 35. main-path shapes ----
    from raytracingproject_tpu_torch.app import cli
    dscene, dflags = cli.load_scene("example:dof_motion")
    dscene.device_update()
    x_kg = dscene.make_kernel_globals(dev)
    x_kg.update(dflags)
    assert not x_kg["use_brute"] and int(x_kg["cam"]["use_motion"]) == 1
    assert int(x_kg["cam"]["width"]) == DOF_SIZE
    merge(errs, check_dof_walks(x_kg, rng))
    accuracy(dev, "dof_motion_adaptive",
             examples.dof_motion_scene(64, 64, spp=128), {}, DOF_RMSE_GATE,
             DOF_FRAC_GATE, twin=np.load(TWIN_DOF)["dof_motion_adaptive"],
             twin_f32=np.load(TWIN_F32)["dof_motion_adaptive"],
             also=(("artifacts/twin_f64.npz (its camera in float32)",
                    np.load(TWIN)["dof_motion_adaptive"]),))
    x_launch, x_st, x_mean = dof_fixed_render(x_kg, card)
    a_launch, a_rec, a_st = full_width(
        card, "example:dof_motion", DOF_SIZE, DOF_SPP, JAX_MEAN_DOF_256,
        0.01, ("cluster_walk", "occlusion_walk"), chunk=DOF_CHUNK)
    log(f"[render] example:dof_motion: adaptive {a_st['adaptive']}, "
        f"{a_st['samples_rendered']} of {a_st['samples_nominal']} samples "
        f"rendered; Msamples/s counts the nominal budget")
    assert a_st["adaptive"]
    for launch in (x_launch, a_launch):
        assert {k for k, v in launch.items() if v} == {
            "cluster_walk", "occlusion_walk"}, "dof: another walk launched"
    dof_device_adaptive(x_kg, card, x_mean)
    counts["cluster_walk"]["dof render"] = count_phase(
        "K2 closest, dof render", "cluster_walk", a_rec["cluster_walk"])
    counts["occlusion_walk"]["dof render"] = count_phase(
        "K3 surface, dof render", "occlusion_walk", a_rec["occlusion_walk"])
    for name, label in (("cluster_walk", "K2"), ("occlusion_walk", "K3")):
        g, x = counts[name]["glossy render"], counts[name]["dof render"]
        log(f"[counts] {label} rows per lane: dof {x['rows']['mean']:.2f}, "
            f"glossy {g['rows']['mean']:.2f}; boxes per lane: dof "
            f"{x['boxes']['mean']:.2f}, glossy {g['boxes']['mean']:.2f}")
    x_times, e = dof_main_path_checks(x_kg, card, a_rec)
    merge(errs, e)
    dof_fixed_vs_adaptive(dev, card, x_kg)

    mark("textured_instanced")
    # ---- textured_instanced: 36. kernel checks; 37. accuracy; 38. full
    # width; 39. main-path shapes ----
    tscene, tflags = cli.load_scene("example:textured_instanced")
    assert not tflags
    t_kg, t_compile, t_bvh = timed_compile(tscene, dev)
    ds = t_kg["dscene"]
    log(f"[compile] example:textured_instanced: {ds['prim_table'].shape[0]} "
        f"prims, {ds['cluster_bounds'].shape[0]} clusters x "
        f"{t_kg['cluster_tris']} triangles, host compile {t_compile:.3f} s, "
        f"of which the BVH builder {t_bvh:.4f} s")
    assert ds["prim_table"].shape[0] == 8450 and not t_kg["has_instances"]
    assert ds["cluster_bounds"].shape[0] == 385 and t_kg["cluster_tris"] == 30
    from raytracingproject_tpu_torch.ops import integrator as integ
    assert integ._closest_walk_name(t_kg) == "cluster_walk"
    assert integ._use_occlusion_walk(t_kg)
    merge(errs, check_single_level(t_kg, rng, "cluster_walk",
                                   "textured_instanced"))
    accuracy(dev, "textured_instanced",
             examples.instanced_scene(64, 64, spp=128), {}, TEX_RMSE_GATE,
             TEX_FRAC_GATE, twin=np.load(TWIN_R04)["textured_instanced"],
             twin_f32=np.load(TWIN_F32_R04)["textured_instanced"],
             also=(("artifacts/twin_f64.npz (before the box-filtered "
                    "checker)", np.load(TWIN)["textured_instanced"]),))
    t_launch, t_rec, t_st = full_width(
        card, "example:textured_instanced", TEX_SIZE, TEX_SPP,
        JAX_MEAN_TEX_256, 0.005, ("cluster_walk", "occlusion_walk"),
        chunk=TEX_CHUNK)
    assert {k for k, v in t_launch.items() if v} == {
        "cluster_walk", "occlusion_walk"}, "textured: another walk launched"
    t_times, e = textured_main_path_checks(t_kg, card, t_rec, counts)
    merge(errs, e)

    mark("instanced_scene(grid=5)")
    # ---- instanced_scene(grid=5), 599 clusters: 40. kernel checks; 41.
    # reduced render; 42. counts and times ----
    gscene = examples.instanced_scene(GRID5_SIZE, GRID5_SIZE, spp=GRID5_SPP,
                                      grid=5)
    r_kg, r_compile, r_bvh = timed_compile(gscene, dev)
    ds = r_kg["dscene"]
    log(f"[compile] instanced_scene(grid=5): {ds['prim_table'].shape[0]} "
        f"prims, {ds['cluster_bounds'].shape[0]} clusters x "
        f"{r_kg['cluster_tris']} triangles, host compile {r_compile:.3f} s, "
        f"of which the BVH builder {r_bvh:.4f} s")
    assert ds["prim_table"].shape[0] == 13202 and not r_kg["has_instances"]
    assert ds["cluster_bounds"].shape[0] == 599 and r_kg["cluster_tris"] == 32
    assert integ._closest_walk_name(r_kg) == "tile_walk"
    assert integ._use_occlusion_walk(r_kg)
    merge(errs, check_single_level(r_kg, rng, "tile_walk", "grid=5"))
    r_launch, r_rec, r_st = grid5_render(card, gscene, r_kg, r_compile)
    rk4 = _positional("tile_walk", r_rec["tile_walk"])
    counts["tile_walk"]["grid=5 render"] = order_count_phase(
        "K4 closest, grid=5 render (599 clusters)", "tile_walk", rk4[:8],
        rk4[8])
    r_times, e = grid5_main_path_checks(r_kg, card, r_rec, cap_times)
    merge(errs, e)

    mark("instanced_scene(grid=6)")
    # ---- instanced_scene(grid=6), 577 clusters with instance rows: 43.
    # compile and kernel checks; 44. accuracy; 45. full width; 46. counts
    # and times ----
    i_kg = instanced_compile("example:instanced_grid6", dev, 530, 577, 38,
                             "tile_walk")
    merge(errs, check_single_level(i_kg, rng, "tile_walk", "grid=6",
                                   instances=True))
    pair6 = np.load(TWIN_GRID6)
    d32 = pair6["f32_jax"] - pair6["f64"]
    rmse6 = float(np.sqrt(np.mean(d32 * d32)))
    frac6 = float((np.abs(d32).sum(-1) > 1e-3).mean())
    log(f"[accuracy] instanced_grid6: the JAX package's f32 render vs the "
        f"twin: rmse {rmse6:.3e}, pixels off >1e-3 {frac6:.5f}")
    accuracy(dev, "instanced_grid6",
             examples.instanced_scene(64, 64, spp=128, grid=6), {},
             2.0 * rmse6, max(2.0 * frac6, TEX_FRAC_GATE),
             twin=pair6["f64"], twin_f32=pair6["f32_jax"])
    i_launch, i_rec, i_st = full_width(
        card, "example:instanced_grid6", INST_SIZE, INST_SPP,
        JAX_MEAN_GRID6_256, 0.005, ("tile_walk", "occlusion_walk"),
        chunk=INST_CHUNK)
    assert {k for k, v in i_launch.items() if v} == {
        "tile_walk", "occlusion_walk"}, "grid=6: another walk launched"
    rk4 = _positional("tile_walk", i_rec["tile_walk"])
    counts["tile_walk"]["grid=6 render"] = order_count_phase(
        "K4 closest, grid=6 render (instance rows)", "tile_walk", rk4[:8],
        rk4[8], instances=True)
    counts["occlusion_walk"]["grid=6 render"] = count_phase(
        "K3 surface, grid=6 render (instance rows)", "occlusion_walk",
        i_rec["occlusion_walk"])
    i_times, e = grid6_main_path_checks(i_kg, card, i_rec)
    merge(errs, e)

    mark("instanced_scene(grid=5, nlat=15)")
    # ---- instanced_scene(grid=5, nlat=15), 401 clusters with instance
    # rows: 47. compile and kernel checks; 48. full width, unfused and
    # fused; 49. counts and times ----
    n_kg = instanced_compile("example:instanced_grid5_nlat15", dev, 674, 401,
                             48, "cluster_walk")
    merge(errs, check_single_level(n_kg, rng, "cluster_walk",
                                   "grid=5 nlat=15", instances=True))
    merge(errs, check_dual_instanced(n_kg, rng, "grid=5 nlat=15"))
    n_launch, n_rec, n_st = full_width(
        card, "example:instanced_grid5_nlat15", INST_SIZE, INST_SPP,
        JAX_MEAN_GRID5N15_256, 0.005, ("cluster_walk", "occlusion_walk"),
        chunk=INST_CHUNK)
    assert {k for k, v in n_launch.items() if v} == {
        "cluster_walk", "occlusion_walk"}, "grid=5 nlat=15: another walk"
    nf_launch, nf_rec, nf_st = full_width(
        card, "example:instanced_grid5_nlat15:fused", INST_SIZE, INST_SPP,
        JAX_MEAN_GRID5N15_256, 0.005, ("dual_walk",), chunk=INST_CHUNK)
    assert {k for k, v in nf_launch.items() if v} == {"dual_walk"}, \
        "grid=5 nlat=15 fused: another walk launched"
    for name, label in (("cluster_walk", "K2 closest"),
                        ("occlusion_walk", "K3 surface")):
        counts[name]["grid=5 nlat=15 render"] = count_phase(
            f"{label}, grid=5 nlat=15 render (instance rows)", name,
            n_rec[name])
    counts["dual_walk"]["grid=5 nlat=15 fused render"] = dual_count_phase(
        "K7, grid=5 nlat=15 fused render (instance rows)",
        nf_rec["dual_walk"])
    n_times, e = grid5n15_main_path_checks(n_kg, card, n_rec,
                                           nf_rec["dual_walk"])
    merge(errs, e)

    mark("glossy_deform")
    # ---- glossy_deform (motion rows, 179 clusters x 15): 50. compile and
    # kernel checks; 51. accuracy; 52. full width, the K2 and the K4
    # dispatch; 53. counts and times ----
    gd_kg = deform_compile("example:glossy_deform", dev, kg)
    merge(errs, check_motion_walks(gd_kg, kg, rng))
    twin, twin32, rmse_gate, frac_gate, _ = deform_twin("glossy_deform")
    accuracy(dev, "glossy_deform",
             examples.glossy_deform_scene(64, 64, spp=128), {}, rmse_gate,
             frac_gate, twin=twin, twin_f32=twin32)
    gd_launch, gd_rec, gd_st = full_width(
        card, "example:glossy_deform", DEFORM_SIZE, DEFORM_SPP,
        JAX_MEAN_GLOSSY_DEFORM_256, 0.005, ("cluster_walk", "occlusion_walk"),
        chunk=DEFORM_CHUNK)
    assert {k for k, v in gd_launch.items() if v} == {
        "cluster_walk", "occlusion_walk"}, "glossy_deform: another walk"
    gt_launch, gt_rec, gt_st = full_width(
        card, "example:glossy_deform:tile", DEFORM_SIZE, DEFORM_SPP,
        JAX_MEAN_GLOSSY_DEFORM_256, 0.005, ("tile_walk", "occlusion_walk"),
        chunk=DEFORM_CHUNK)
    assert {k for k, v in gt_launch.items() if v} == {
        "tile_walk", "occlusion_walk"}, "glossy_deform:tile: another walk"
    gd_times, e = glossy_deform_main_path_checks(gd_kg, card, gd_rec, gt_rec,
                                                 counts)
    merge(errs, e)

    mark("cornell_deform")
    # ---- cornell_deform (a three-step path on the dense sweep): 54.
    # compile and kernel checks; 55. accuracy; 56. full width; 57. counts
    # and times ----
    cd_kg = deform_compile("example:cornell_deform", dev, ckg)
    merge(errs, check_deform_dense(cd_kg, ckg, rng))
    twin, twin32, rmse_gate, frac_gate, _ = deform_twin("cornell_deform")
    accuracy(dev, "cornell_deform",
             examples.cornell_deform_scene(64, 64, spp=128), {}, rmse_gate,
             frac_gate, twin=twin, twin_f32=twin32)
    cd_launch, cd_rec, cd_st = full_width(
        card, "example:cornell_deform", DEFORM_SIZE, DEFORM_SPP,
        JAX_MEAN_CORNELL_DEFORM_256, 0.005, ("dense_closest", "dense_any"),
        chunk=DEFORM_CHUNK)
    assert {k for k, v in cd_launch.items() if v} == {
        "dense_closest", "dense_any"}, "cornell_deform: another kernel"
    cd_times, e = deform_dense_main_path_checks(cd_kg, card, cd_rec, counts)
    merge(errs, e)

    mark("glossy_deform_big")
    # ---- glossy_deform_big (two-level motion tables, 936 clusters x 64):
    # 58. compile and kernel checks; 59. accuracy; 60. full width, K5 and
    # K6; 61. counts and times ----
    gb_static = examples.glossy_big_scene(DEFORM_SIZE, DEFORM_SIZE, spp=1)
    gb_static.device_update()
    gb_static_kg = gb_static.make_kernel_globals(dev)
    gb_kg = deform_big_compile(dev, gb_static_kg)
    merge(errs, check_motion_two_level(gb_kg, gb_static_kg, rng))
    twin, twin32, rmse_gate, frac_gate, unstable = deform_twin(
        "glossy_deform_big")
    accuracy(dev, "glossy_deform_big",
             examples.glossy_deform_big_scene(64, 64, spp=128), {},
             rmse_gate, frac_gate, twin=twin, twin_f32=twin32,
             unstable=unstable)
    gb_launch, gb_rec, gb_st = full_width(
        card, "example:glossy_deform_big", DEFORM_SIZE, DEFORM_SPP,
        JAX_MEAN_GLOSSY_DEFORM_BIG_256, 0.005, ("cluster2_walk",),
        chunk=DEFORM_CHUNK)
    assert {k for k, v in gb_launch.items() if v} == {"cluster2_walk"}, \
        "glossy_deform_big: another walk launched"
    go_launch, go_rec, go_st = full_width(
        card, "example:glossy_deform_big:onehot2", DEFORM_SIZE, DEFORM_SPP,
        JAX_MEAN_GLOSSY_DEFORM_BIG_256, 0.005, ("onehot2_walk",),
        chunk=DEFORM_CHUNK)
    assert {k for k, v in go_launch.items() if v} == {"onehot2_walk"}, \
        "glossy_deform_big:onehot2: another walk launched"
    gb_times, e = deform_big_main_path_checks(gb_kg, card, gb_rec, go_rec,
                                              counts)
    merge(errs, e)

    paths = {"glossy_nee_mis": (g_launch, g_st), "volume_sss": (v_launch, v_st),
             "big_instanced": (b_launch, b_st),
             "cornell_diffuse": (c_launch, c_st),
             "volume_sss_dense": (d_launch, d_st),
             "big_instanced_onehot2": (o_launch, o_st),
             "glossy_nee_mis_fused": (f_launch, f_st),
             "dof_motion_adaptive": (a_launch, a_st),
             "dof_motion_adaptive_fixed": (x_launch, x_st),
             "textured_instanced": (t_launch, t_st),
             "instanced_grid5": (r_launch, r_st),
             "instanced_grid6": (i_launch, i_st),
             "instanced_grid5_nlat15": (n_launch, n_st),
             "instanced_grid5_nlat15_fused": (nf_launch, nf_st),
             "glossy_deform": (gd_launch, gd_st),
             "glossy_deform_tile": (gt_launch, gt_st),
             "cornell_deform": (cd_launch, cd_st),
             "glossy_deform_big": (gb_launch, gb_st),
             "glossy_deform_big_onehot2": (go_launch, go_st)}
    by_path = {name: {path: launch[name]
                      for path, (launch, _st) in paths.items()}
               for name in WRAPPERS}
    log("[render] Msamples/s: " + ", ".join(
        f"{path} {st['msamples_per_s']:.4f}"
        for path, (_l, st) in paths.items()) + f" ({card})")
    times = {**g_times, **v_times, **b_times, **c_times, **d_times,
             **o_times, **f_times, **cap_times, **x_times, **t_times,
             **r_times, **i_times, **n_times, **gd_times, **cd_times,
             **gb_times}
    # kernel, source, the TPU kernel's pallas_call, its timed case, the
    # prefix of its other cases
    k1 = ("dense_sweep", "pallas_intersect.py:156")
    rows = (("dense_closest", *k1, "K1 closest render (volume_sss)",
             "K1 closest"),
            ("dense_any", *k1, "K1 any render (cornell)", "K1 any"),
            ("dense_dual", *k1, "K1 dual render (volume_sss)", "K1 dual"),
            ("cluster_walk", "cluster_walk", "pallas_onehot.py:1008",
             "K2 closest render", "K2"),
            ("occlusion_walk", "occlusion_walk", "pallas_cluster.py:811",
             "K3 dual render", "K3"),
            ("tile_walk", "tile_walk", "pallas_cluster.py:253",
             "K4 closest render", "K4"),
            ("cluster2_walk", "cluster2_walk", "pallas_cluster.py:565",
             "K5 closest render", "K5"),
            ("onehot2_walk", "onehot2_walk", "pallas_onehot.py:619",
             "K6 closest render", "K6"),
            ("dual_walk", "dual_walk", "pallas_onehot.py:929",
             "K7 dual render", "K7"))
    kern = []
    for name, source, tpu, case, prefix in rows:
        tm = times[case]
        assert sum(by_path[name].values()) > 0, f"{name} never launched"
        kern.append({
            "name": name, "route": "cuda",
            "source": f"raytracingproject_tpu_torch/csrc/{source}.cu",
            "replaces": f"raytracingproject_tpu/ops/{tpu}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": errs[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "timed_case": case, "lanes": tm["lanes"],
            "cases": {c: t for c, t in times.items()
                      if c.startswith(prefix)}})
        if "counted_bound_ms" in tm:
            kern[-1]["counted_bound_ms"] = tm["counted_bound_ms"]
        kern[-1]["modes"] = MODES[name]
        if name in INSTANCE_CASES:
            # the instance-row mode: its launches on the instanced paths
            # and its time on its own recorded input
            tc = INSTANCE_CASES[name]
            ti = times[tc]
            n_inst = sum(by_path[name][p] for p in INSTANCE_PATHS)
            assert n_inst > 0, f"{name}: no launch with instance rows"
            kern[-1]["instance_rows"] = {
                "launches": n_inst, "timed_case": tc, "ms": ti["ms"],
                "plain_ms": ti["plain_ms"], "bound_ms": ti["bound_ms"],
                "bound_by": ti["bound_by"], "lanes": ti["lanes"]}
        if name in MOTION_CASES:
            # the motion mode (motion rows, K1's deform modes): its
            # launches on the deforming paths and its time on its own
            # recorded input
            tc = MOTION_CASES[name]
            ti = times[tc]
            n_mot = sum(by_path[name][p] for p in MOTION_PATHS)
            assert n_mot > 0, f"{name}: no launch with motion"
            kern[-1]["motion"] = {
                "launches": n_mot, "timed_case": tc, "ms": ti["ms"],
                "plain_ms": ti["plain_ms"], "bound_ms": ti["bound_ms"],
                "bound_by": ti["bound_by"], "lanes": ti["lanes"]}
            if "counted_bound_ms" in ti:
                kern[-1]["motion"]["counted_bound_ms"] = \
                    ti["counted_bound_ms"]
        if name in counts:
            kern[-1]["counts"] = counts[name]
    # K1's fourth mode computes the TPU kernel's own Moeller-Trumbore
    # contract, which no render of either package calls: its checks and
    # times ride on the closest mode's entry
    assert by_path["dense_mt"] == {path: 0 for path in paths}
    kern[0]["mt_mode"] = {
        "max_abs_err": errs["dense_mt"], "launches": 0,
        "cases": {c: t for c, t in times.items() if c.startswith("K1 mt")}}
    print(card_line())
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
