"""Scene container and host compile (JAX counterpart:
raytracingproject_tpu/models/scene.py `Scene.device_update` +
`make_kernel_globals`).

The card has no JAX, so the port owns its host compile. It is numpy
only and covers the port's scenes:
- geometry: static single-user meshes baked to world space, with
  deforming motion (a mesh's "std_motion_vertex_position" path resampled
  onto the scene's uniform shutter steps, the JAX package's :597-622,
  :990-1010: tri_verts_world_t1 / tri_verts_world_steps for the dense
  sweeps, and cluster rows with a shutter delta block for a two-step
  path; a path of three steps or more keeps no cluster tables), and
  instancing (the JAX package's static vs instanced split :485-497): a
  geometry with several users in a scene of more than
  AUTO_FLATTEN_MAX_PRIMS flat prims keeps one object-space BLAS, and each
  user becomes an instance row; the SAH build and cluster cut are the
  port's own bvh/build.py and bvh/clusters.py;
- the dense-path arrays of static scenes (tri_verts_world,
  prim_object_packed, object_visibility, prim_is_boundary: what the dense
  sweep K1 reads; a scene of at most BRUTE_VS_CLUSTER_PRIMS static prims
  records use_brute, the JAX package's dense-sweep choice);
- the cluster tables, from CLUSTER_MIN_PRIMS prims on and for every
  instanced scene (instance clusters carry world bounds and their
  instance's w2o) and, past CLUSTER_MAX_SINGLE_LEVEL clusters, the
  two-level supercluster table sc_bounds and sc_gmax (the K5 and K6
  walks);
- the wide prim/object tables, with object transforms for instanced
  objects;
- the light distribution over emissive triangles and lamps, the lamp
  table and the per-entry row snapshots;
- the background shader slot and the texture store (ImageManager);
- for volume scenes the volume-boundary tables, the per-shader volume
  lists and shadow-invisible volume-only objects.
Every array is built with the same numpy operations in the same order as
the JAX package, so the tables come out bit-identical
(tests/test_torch_scene.py, tests/test_torch_volume_render.py,
tests/test_torch_instanced.py, tests/test_torch_dense.py). The TLAS and
the packed-BVH traversal arrays are not built, nor the bf16x3 one-hot
tables (oh_*, oh2_*): no render path of the port reads them.

Raising NotImplementedError: object motion, hair, subdivision, displacement,
portals, background lamps (the importance map), IES profiles, the light
tree, transparent film, image files, and static scenes of 2,048 prims or
more (the JAX package's native C++ BVH construction).

`make_kernel_globals(device)` returns the `KernelGlobals` dict: arrays
as torch tensors on `device` under "dscene", statics under the JAX key
names. `kg_from_jax` converts the JAX package's kernel globals into the
same form (arrays through numpy, shader graphs rebuilt from port nodes).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch.bvh import build as bvh_build
from raytracingproject_tpu_torch.bvh import clusters as cl_mod
from raytracingproject_tpu_torch.models import light as light_mod
from raytracingproject_tpu_torch.models import shader_nodes as sn
from raytracingproject_tpu_torch.models.background import Background
from raytracingproject_tpu_torch.models.camera import Camera
from raytracingproject_tpu_torch.models.film import Film
from raytracingproject_tpu_torch.models.image import ImageManager, TextureStore
from raytracingproject_tpu_torch.models.integrator import Integrator
from raytracingproject_tpu_torch.models.mesh import \
    ATTR_STD_MOTION_VERTEX_POSITION
from raytracingproject_tpu_torch.models.object import (
    PATH_RAY_ALL_VISIBILITY, PATH_RAY_SHADOW)
from raytracingproject_tpu_torch.models.shader import Shader, ShaderGraph
from raytracingproject_tpu_torch.ops import cluster_intersect as ci
from raytracingproject_tpu_torch.ops import lookup as lk
from raytracingproject_tpu_torch.utils import transform as tfm

# Same thresholds as the JAX package.
BRUTE_FORCE_MAX_PRIMS = 16384
CLUSTER_MIN_PRIMS = 384
BRUTE_VS_CLUSTER_PRIMS = 1024
CLUSTER_MAX_SINGLE_LEVEL = 640
CLUSTER2_GROUP_TARGET = 64
AUTO_FLATTEN_MAX_PRIMS = 16384

# kernel-globals arrays the port's render reads
KG_ARRAYS = ("prim_table", "object_table", "cluster_bounds",
             "cluster_table", "cluster_boundary", "prim_is_boundary",
             "light_dist_type", "light_dist_cdf", "light_entries",
             "le_prim_rows", "le_obj_rows", "le_lamp_rows", "lamp_table",
             "bg_pmf")
# (the cluster tables among them exist from CLUSTER_MIN_PRIMS prims on and
# in every instanced scene)
# the dense sweep's arrays (with prim_is_boundary); object_visibility is
# uint32 on the host and int32 on the device
KG_DENSE = ("tri_verts_world", "prim_object_packed", "object_visibility")
# ... and those only some scenes have (two-level cluster tables)
KG_OPTIONAL = ("sc_bounds",)
# ... and the deforming scenes (the triangles at shutter close and at the
# steps of their path)
KG_DEFORM = ("tri_verts_world_t1", "tri_verts_world_steps")


def _resample_motion_steps(v0, extra_steps, n_extra):
    """A mesh's piecewise-linear vertex path resampled onto n_extra
    uniform shutter steps after t=0. extra_steps: (S_m-1, V, 3) positions
    at times k/(S_m-1); returns (n_extra, V, 3) at times j/n_extra (exact
    where the grids share a point)."""
    if n_extra == 0:
        return np.zeros((0,) + v0.shape, np.float32)
    path = np.concatenate([v0[None], extra_steps], axis=0)  # (S_m, V, 3)
    sm1 = path.shape[0] - 1
    out = np.empty((n_extra,) + v0.shape, np.float32)
    for j in range(1, n_extra + 1):
        tt = j / n_extra * sm1
        k = min(int(np.floor(tt)), sm1 - 1)
        f = tt - k
        out[j - 1] = path[k] if f == 0.0 \
            else (1.0 - f) * path[k] + f * path[k + 1]
    return out


def _geom_extra_steps(geom):
    """Shutter steps after t=0 of a mesh's deform path (0: static)."""
    a = geom.attribute_get(ATTR_STD_MOTION_VERTEX_POSITION)
    if a is None:
        return 0
    return a.data.shape[0] if a.data.ndim == 3 else 1


def default_surface_shader():
    g = ShaderGraph()
    d = g.add(sn.DiffuseBsdfNode("default_diffuse", color=(0.8, 0.8, 0.8)))
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader("default_surface", g)


def default_background_shader():
    g = ShaderGraph()
    b = g.add(sn.BackgroundNode("default_background",
                                color=(0.0, 0.0, 0.0), strength=0.0))
    g.connect(b, "background", g.output_node, "surface")
    return Shader("default_background", g)


class Scene:
    def __init__(self):
        self.camera = Camera("camera")
        self.film = Film("film")
        self.integrator = Integrator("integrator")
        self.background = Background()
        self.image_manager = ImageManager()
        self.objects = []
        self.lights = []
        self.shaders = []
        self.default_surface = default_surface_shader()
        self.default_background = default_background_shader()
        self.add_shader(self.default_surface)
        self.dscene = None

    def add_shader(self, shader):
        if shader not in self.shaders:
            self.shaders.append(shader)
        return shader

    def add_object(self, obj):
        self.objects.append(obj)
        return obj

    def add_light(self, light):
        self.lights.append(light)
        return light

    # ------------------------------------------------------------------
    def device_update(self):
        """Host compile: shaders and images -> geometry/clusters -> lights
        -> camera/film/integrator (the JAX package's order)."""
        if self.background.transparent:
            raise NotImplementedError("transparent film is not ported")
        if self.integrator.use_light_tree:
            raise NotImplementedError("the light tree is not ported")
        if self.background.shader is not None:
            self.add_shader(self.background.shader)
        for li in self.lights:
            if li.shader is not None:
                self.add_shader(li.shader)
        for slot, sh in enumerate(self.shaders):
            sh.slot = slot
            sh.analyze()
            for node in sh.graph.nodes:
                if isinstance(node, sn.ImageTextureNode):
                    if node.slot < 0:
                        src = node.image if node.image is not None \
                            else node.filename
                        node.slot = -1 if src is None or (
                            isinstance(src, str) and not src) \
                            else self.image_manager.add_image(src)
                    if node.use_auto_mip and node.slot >= 0:
                        self.image_manager.want_mips.add(node.slot)
        packed = self._pack_geometry()
        lightd = self._pack_lights(packed)
        arrays = dict(packed)
        arrays.update(lightd)
        arrays["prim_is_boundary"], cbnd = _boundary_tables(
            self.shaders, arrays["prim_table"], arrays.get("cluster_table"),
            packed["__cluster_tris__"], packed["__cluster_motion__"])
        if cbnd is not None:
            arrays["cluster_boundary"] = cbnd
        tex_data, tex_sizes = self.image_manager.device_update()
        bg = self.background.shader
        self.dscene = {
            "arrays": {k: arrays[k] for k in KG_ARRAYS + KG_DENSE + KG_OPTIONAL
                       + KG_DEFORM if k in arrays},
            "cam": self.camera.update(),
            "kint": self.integrator.kernel_record(),
            "filter_table": self.film.build_filter_table(),
            "tex_data": tex_data,
            "tex_sizes": tex_sizes,
            "background_shader": (bg.slot if bg is not None
                                  else self.default_background.slot
                                  if self.default_background in self.shaders
                                  else -1),
            "use_brute": packed["__use_brute__"],
            "has_instances": packed["__has_instances__"],
            "has_deform_motion": packed["__has_deform_motion__"],
            "deform_steps": packed["__deform_steps__"],
            "cluster_tris": packed["__cluster_tris__"],
            "cluster_motion": packed["__cluster_motion__"],
            "sc_gmax": packed["__sc_gmax__"],
            "light_kinds": lightd["__light_kinds__"],
            "volume_stack_depth": int(self.integrator.volume_stack_depth),
        }
        return self.dscene

    # ------------------------------------------------------------------
    def _mesh_arrays(self, mesh, obj_idx, world_tfm, deform_extra=0):
        """Per-triangle arrays of one mesh (world space when world_tfm is
        given, else object space): verts, vertex normals, corner uvs,
        shader slots, smooth flags, the object index, the triangles at the
        scene's deform_extra shutter steps after t=0 ((S-1, T, 3, 3): a
        static mesh repeats its verts) and whether the mesh deforms."""
        v = mesh.verts_array
        t = mesh.triangles_array
        if len(t) == 0:
            return None
        vn_attr = mesh.attribute_get("std_vertex_normal")
        vn = mesh.compute_vertex_normals() if vn_attr is None \
            else vn_attr.data
        mv_attr = mesh.attribute_get(ATTR_STD_MOTION_VERTEX_POSITION)
        steps = None
        if mv_attr is not None:
            mv = np.asarray(mv_attr.data, np.float32)
            steps = _resample_motion_steps(
                v, mv[None] if mv.ndim == 2 else mv, deform_extra)
        if world_tfm is not None:
            v = tfm.transform_point(world_tfm, v)
            if steps is not None and len(steps):
                steps = np.stack([tfm.transform_point(world_tfm, s)
                                  for s in steps])
            itt = np.linalg.inv(tfm.to_4x4(world_tfm))[:3, :3].T
            vn = vn @ itt.T
            ln = np.linalg.norm(vn, axis=-1, keepdims=True)
            vn = vn / np.maximum(ln, 1e-12)
        uv_attr = mesh.attribute_get("std_uv")
        if uv_attr is None:
            uv = np.tile(np.array([[0, 0], [1, 0], [1, 1]], np.float32),
                         (len(t), 1, 1))
        elif uv_attr.element == "corner":
            uv = uv_attr.data.reshape(-1, 3, 2)[: len(t)]
        else:
            uv = uv_attr.data[t]
        deform = steps is not None
        if steps is None:
            steps = np.broadcast_to(v, (deform_extra,) + v.shape)
        return {"verts": v[t], "steps": steps[:, t], "deform": deform,
                "vnormal": vn[t], "uv": uv,
                "shader": np.array(
                    [self._shader_slot(mesh, s)
                     for s in np.asarray(mesh.shader, np.int32)], np.int32),
                "smooth": np.asarray(mesh.smooth, bool),
                "object": np.full(len(t), obj_idx, np.int32)}

    @staticmethod
    def _block(parts):
        """One BVH block over concatenated mesh arrays, in build order."""
        def cat(key, tail, dtype=np.float32):
            if parts:
                return np.concatenate([p[key] for p in parts]).astype(dtype)
            return np.zeros((0,) + tail, dtype)

        verts = cat("verts", (3, 3))
        # the tree is built over the shutter-open triangles (object
        # splits only, as the JAX package keeps for deforming meshes)
        bvh = bvh_build.build_bvh(verts.min(1), verts.max(1))
        order = bvh.prim_order
        steps = np.ascontiguousarray(np.concatenate(
            [p["steps"] for p in parts], axis=1).astype(np.float32)[:, order])
        return {"children": bvh.children, "verts": verts[order],
                "verts_steps": steps,
                "verts_t1": steps[-1] if len(steps) else verts[order],
                "vnormal": cat("vnormal", (3, 3))[order],
                "uv": cat("uv", (3, 2))[order],
                "shader": cat("shader", (), np.int32)[order],
                "smooth": cat("smooth", (), bool)[order],
                "object": cat("object", (), np.int32)[order]}

    def _pack_geometry(self):
        objects = self.objects
        nobj = max(len(objects), 1)
        geom_users = {}
        for oi, obj in enumerate(objects):
            if obj.use_motion:
                raise NotImplementedError("object motion is not ported")
            geom_users.setdefault(id(obj.geometry), []).append(oi)
        # the flattened size decides whether shared geometry is baked to
        # world space or instanced
        total_flat = sum(o.geometry.num_triangles for o in objects)
        flatten_all = total_flat <= AUTO_FLATTEN_MAX_PRIMS
        static_objs = []
        instanced_geoms = {}  # id(geom) -> (geom, [object indices])
        for oi, obj in enumerate(objects):
            if len(geom_users[id(obj.geometry)]) == 1 or flatten_all:
                static_objs.append(oi)
            else:
                instanced_geoms.setdefault(
                    id(obj.geometry), (obj.geometry, []))[1].append(oi)
        has_instances = len(instanced_geoms) > 0
        # the scene-wide deform step count: every deforming mesh's path is
        # resampled onto the common S-1 uniform steps after shutter open
        deform_extra = max([_geom_extra_steps(o.geometry)
                            for o in objects] + [0])

        # static merged geometry (world space), then one object-space
        # BLAS per instanced geometry
        blocks = []
        static_parts = [p for p in (
            self._mesh_arrays(objects[oi].geometry, oi,
                              np.asarray(objects[oi].transform, np.float32),
                              deform_extra)
            for oi in static_objs) if p is not None]
        deform_seen = any(p["deform"] for p in static_parts)
        if static_parts:
            blocks.append(self._block(static_parts))
        geom_blas = {}
        for gid, (geom, _users) in instanced_geoms.items():
            geom_blas[gid] = len(blocks)
            part = self._mesh_arrays(geom, -1, None, deform_extra)
            deform_seen = deform_seen or part["deform"]
            blocks.append(self._block([part]))
        if not blocks:
            raise NotImplementedError("empty scenes are not ported")

        # instance rows: (w2o, block, object index); the static block is
        # instance 0 with the identity
        instance_rows = []
        if has_instances:
            if static_parts:
                instance_rows.append((tfm.identity(), 0, -1))
            for gid, (_geom, users) in instanced_geoms.items():
                for oi in users:
                    instance_rows.append((tfm.inverse(np.asarray(
                        objects[oi].transform, np.float32)),
                        geom_blas[gid], oi))
        prim_bases, pb = [], 0
        for blk in blocks:
            prim_bases.append(pb)
            pb += len(blk["verts"])
        P = pb
        packed = {k: np.concatenate([blk[k] for blk in blocks])
                  for k in ("verts", "vnormal", "uv", "shader", "smooth",
                            "object")}

        # ---- object tables (merged objects: identity packed transforms)
        obj_tfm = np.tile(tfm.identity(), (nobj, 1, 1))
        obj_itfm = np.tile(tfm.identity(), (nobj, 1, 1))
        obj_itfm_gen = np.tile(tfm.identity(), (nobj, 1, 1))
        obj_color = np.zeros((nobj, 3), np.float32)
        obj_random = np.zeros(nobj, np.float32)
        obj_visibility = np.full(nobj, PATH_RAY_ALL_VISIBILITY, np.uint32)
        obj_flags = np.zeros(nobj, np.uint32)
        obj_blo = np.zeros((nobj, 3), np.float32)
        obj_bhi = np.ones((nobj, 3), np.float32)
        for oi, obj in enumerate(objects):
            t = np.asarray(obj.transform, np.float32)
            inv = tfm.inverse(t)
            merged = oi in static_objs
            obj_tfm[oi] = tfm.identity() if merged else t
            obj_itfm[oi] = tfm.identity() if merged else inv
            obj_itfm_gen[oi] = inv
            obj_color[oi] = np.asarray(obj.color, np.float32)
            obj_random[oi] = (obj.random_id & 0xFFFF) / 65535.0
            vis = np.uint32(obj.visibility)
            # volume-only boundaries never block shadow rays
            if all(s.volume_only for s in (obj.geometry.used_shaders
                                           or [self.default_surface])):
                vis &= ~np.uint32(PATH_RAY_SHADOW)
            obj_visibility[oi] = vis
            obj_flags[oi] = np.uint32(obj.flags())
            obj_blo[oi], obj_bhi[oi] = obj.geometry.compute_bounds()

        # ---- dense-path arrays (world-space triangles: static scenes) --
        packed["tri_verts_world"] = packed["verts"]
        packed["prim_object_packed"] = packed["object"]
        packed["object_visibility"] = obj_visibility
        packed["__has_instances__"] = has_instances
        # deforming motion of instanced geometry has no port path (nor a
        # kernel path in the JAX package): it compiles as static
        has_deform = deform_seen and not has_instances
        packed["__has_deform_motion__"] = has_deform
        packed["__deform_steps__"] = deform_extra + 1 if has_deform else 1
        if has_deform:
            packed["tri_verts_world_t1"] = blocks[0]["verts_t1"]
            # the whole (S-1, P, 3, 3) path, for the dense sweeps'
            # hat-weighted evaluation
            packed["tri_verts_world_steps"] = blocks[0]["verts_steps"]
        packed["__cluster_tris__"] = 0
        packed["__cluster_motion__"] = False
        packed["__sc_gmax__"] = 0
        # cluster rows carry one shutter delta per triangle (a two-step
        # lerp): a path of three steps or more rides the dense sweep
        if (has_instances or P >= CLUSTER_MIN_PRIMS) \
                and not (has_deform and deform_extra > 1):
            self._pack_clusters(packed, blocks, instance_rows, prim_bases,
                                obj_visibility)
        # the dense sweep where no cluster table exists or the scene is
        # small; instanced triangles exist only in object space: never
        packed["__use_brute__"] = (not has_instances) and (
            "cluster_bounds" not in packed or P <= BRUTE_VS_CLUSTER_PRIMS)
        # ---- wide lookup tables (ops/lookup.py layout) ----
        pt = np.zeros((P, lk.PT_COLS), np.float32)
        pt[:, lk.PT_V0:lk.PT_V0 + 9] = packed["verts"].reshape(P, 9)
        pt[:, lk.PT_VN:lk.PT_VN + 9] = packed["vnormal"].reshape(P, 9)
        pt[:, lk.PT_UV:lk.PT_UV + 6] = packed["uv"].reshape(P, 6)
        pt[:, lk.PT_SHADER] = packed["shader"]
        pt[:, lk.PT_SMOOTH] = packed["smooth"]
        pt[:, lk.PT_OBJECT] = packed["object"]
        packed["prim_table"] = pt

        ot = np.zeros((nobj, lk.OT_COLS), np.float32)
        ot[:, lk.OT_TFM:lk.OT_TFM + 12] = obj_tfm.reshape(nobj, 12)
        ot[:, lk.OT_ITFM:lk.OT_ITFM + 12] = obj_itfm.reshape(nobj, 12)
        ot[:, lk.OT_ITFM_GEN:lk.OT_ITFM_GEN + 12] = \
            obj_itfm_gen.reshape(nobj, 12)
        ot[:, lk.OT_COLOR:lk.OT_COLOR + 3] = obj_color
        ot[:, lk.OT_RANDOM] = obj_random
        ot[:, lk.OT_BOUNDS_LO:lk.OT_BOUNDS_LO + 3] = obj_blo
        ot[:, lk.OT_BOUNDS_HI:lk.OT_BOUNDS_HI + 3] = obj_bhi
        ot[:, lk.OT_VISIBILITY] = obj_visibility.astype(np.float32)
        ot[:, lk.OT_FLAGS] = obj_flags.astype(np.float32)
        packed["object_table"] = ot
        return packed

    def _pack_clusters(self, packed, blocks, instance_rows, prim_bases,
                       obj_visibility):
        """Cluster tables (and, past CLUSTER_MAX_SINGLE_LEVEL clusters,
        the two-level supercluster table) into `packed`."""
        objects = self.objects
        has_instances = packed["__has_instances__"]
        two_level = False
        for ct_size in (16, 32, 64):
            block_cuts = [cl_mod.cut_clusters(blk["children"], ct_size)
                          for blk in blocks]
            total_c = (sum(len(block_cuts[r[1]]) for r in instance_rows)
                       if has_instances else len(block_cuts[0]))
            if total_c <= CLUSTER_MAX_SINGLE_LEVEL:
                break
        else:
            if total_c > 512 * 512:
                raise NotImplementedError(
                    f"{total_c} clusters: past the two-level tables' "
                    "capacity the JAX package walks its packed BVH, which "
                    "is not ported")
            two_level = True
        cds = []
        if has_instances:
            for (w2o, bi, oi) in instance_rows:
                blk = blocks[bi]
                o2w = (np.asarray(objects[oi].transform, np.float32)
                       if oi >= 0 else tfm.identity())
                for (s, c) in block_cuts[bi]:
                    verts = blk["verts"][s:s + c]
                    objv = (np.full(c, oi, np.int32) if oi >= 0
                            else blk["object"][s:s + c])
                    vlo = verts.reshape(-1, 3).min(0)
                    vhi = verts.reshape(-1, 3).max(0)
                    corners = np.array(
                        [[x, y, z] for x in (vlo[0], vhi[0])
                         for y in (vlo[1], vhi[1])
                         for z in (vlo[2], vhi[2])], np.float32)
                    wc = tfm.transform_point(o2w, corners)
                    cds.append({"verts": verts,
                                "prim": prim_bases[bi] + np.arange(s, s + c),
                                "obj": objv,
                                "vis": obj_visibility[np.maximum(objv, 0)],
                                "w2o": w2o, "lo": wc.min(0), "hi": wc.max(0)})
        else:
            tv, po = packed["verts"], packed["object"]
            tv1 = packed.get("tri_verts_world_t1")
            for (s, c) in block_cuts[0]:
                verts = tv[s:s + c]
                objv = po[s:s + c]
                # deforming: the bounds cover both shutter ends, and the
                # row carries each triangle's shutter delta
                allv = verts.reshape(-1, 3) if tv1 is None \
                    else np.concatenate([verts, tv1[s:s + c]]).reshape(-1, 3)
                cds.append({"verts": verts,
                            "verts_t1": None if tv1 is None else tv1[s:s + c],
                            "prim": np.arange(s, s + c),
                            "obj": objv,
                            "vis": obj_visibility[np.maximum(objv, 0)],
                            "lo": allv.min(0), "hi": allv.max(0)})
        cb, ctab, ct_used = ci.pack_cluster_table(cds)
        packed["cluster_bounds"] = cb
        packed["cluster_table"] = ctab
        packed["__cluster_tris__"] = ct_used
        packed["__cluster_motion__"] = any(
            cd.get("verts_t1") is not None for cd in cds)
        if two_level:
            gmax = max(CLUSTER2_GROUP_TARGET, -(-total_c // 512))
            gmax = -(-gmax // 8) * 8
            if has_instances:
                # each instance's clusters are consecutive: chunk them
                groups, base = [], 0
                for r in instance_rows:
                    nci = len(block_cuts[r[1]])
                    for k in range(0, nci, gmax):
                        groups.append((base + k, min(gmax, nci - k)))
                    base += nci
            else:
                super_cuts = cl_mod.cut_clusters(blocks[0]["children"],
                                                 gmax * ct_size)
                groups = cl_mod.group_superclusters(block_cuts[0],
                                                    super_cuts, gmax)
            if len(groups) > 512:
                # plain chunking keeps SC <= 512
                gmax = -(-(-(-total_c // 512)) // 8) * 8
                groups = [(k, min(gmax, total_c - k))
                          for k in range(0, total_c, gmax)]
            packed["sc_bounds"] = cl_mod.supercluster_bounds(cb, groups)
            packed["__sc_gmax__"] = gmax

    def _shader_slot(self, mesh, local_idx):
        """Mesh-local shader index -> scene shader slot."""
        if mesh.used_shaders and 0 <= local_idx < len(mesh.used_shaders):
            sh = mesh.used_shaders[local_idx]
            if sh not in self.shaders:
                self.add_shader(sh)
                sh.slot = self.shaders.index(sh)
                sh.analyze()
            return self.shaders.index(sh)
        return self.default_surface.slot

    # ------------------------------------------------------------------
    def _pack_lights(self, packed):
        """Flat emission distribution over emissive triangles, then lamps
        (type 1 = triangle, 0 = lamp; weight = power)."""
        entries = []  # (type, prim or lamp index, power)
        prim_shader = packed["shader"]
        prim_obj = packed["object"]
        tri_verts = packed["verts"]
        P = len(prim_shader)
        prim_emission = np.zeros((P, 3), np.float32)
        emis_by_slot = {}
        for sh in self.shaders:
            est = estimate_constant_emission(sh)
            if est is not None and np.any(est > 0):
                emis_by_slot[sh.slot] = est
        for slot, est in emis_by_slot.items():
            # instanced prims (object -1) are never lights
            idxs = np.nonzero((prim_shader == slot) & (prim_obj >= 0))[0]
            prim_emission[idxs] = est
            for pi in idxs:
                v = tri_verts[pi]
                area = 0.5 * np.linalg.norm(
                    np.cross(v[1] - v[0], v[2] - v[0]))
                lum = float(0.2126 * est[0] + 0.7152 * est[1]
                            + 0.0722 * est[2])
                entries.append((1, int(pi), max(lum * area * np.pi, 1e-12)))

        nl = max(len(self.lights), 1)
        la = {
            "type": np.zeros(nl, np.int32),
            "co": np.zeros((nl, 3), np.float32),
            "dir": np.zeros((nl, 3), np.float32),
            "size": np.zeros(nl, np.float32),
            "axisu": np.zeros((nl, 3), np.float32),
            "axisv": np.zeros((nl, 3), np.float32),
            "sizeu": np.ones(nl, np.float32),
            "sizev": np.ones(nl, np.float32),
            "strength": np.zeros((nl, 3), np.float32),
            "angle": np.zeros(nl, np.float32),
            "spot_angle": np.zeros(nl, np.float32),
            "spot_smooth": np.zeros(nl, np.float32),
            "pmf": np.zeros(nl, np.float32),
        }
        for li, light in enumerate(self.lights):
            ltype = light.get_enum_int("light_type")
            if light.is_portal:
                raise NotImplementedError("light portals are not ported")
            if ltype == light_mod.LIGHT_BACKGROUND:
                raise NotImplementedError(
                    "background lamps (the importance map) are not ported")
            if light.ies.strip():
                raise NotImplementedError("IES profiles are not ported")
            la["type"][li] = ltype
            la["co"][li] = np.asarray(light.co, np.float32)
            d = np.asarray(light.dir, np.float32)
            la["dir"][li] = d / max(np.linalg.norm(d), 1e-12)
            la["size"][li] = light.size
            la["axisu"][li] = np.asarray(light.axisu, np.float32)
            la["axisv"][li] = np.asarray(light.axisv, np.float32)
            la["sizeu"][li] = light.sizeu
            la["sizev"][li] = light.sizev
            strength = np.asarray(light.strength, np.float32)
            if light.shader is not None:
                est = estimate_constant_emission(light.shader)
                if est is not None:
                    strength = est
            la["strength"][li] = strength
            la["angle"][li] = light.angle
            la["spot_angle"][li] = light.spot_angle
            la["spot_smooth"][li] = light.spot_smooth
            entries.append((0, li, light.total_power()))

        D = len(entries)
        if D == 0:
            raise NotImplementedError("scenes without emitters are not "
                                      "ported")
        powers = np.array([e[2] for e in entries], np.float64)
        cdf = np.concatenate([[0.0], np.cumsum(powers / powers.sum())])
        cdf[-1] = 1.0
        pmfs = (powers / powers.sum()).astype(np.float32)
        prim_light_pmf = np.zeros(max(P, 1), np.float32)
        for ei, (etype, eid, _p) in enumerate(entries):
            if etype == 1:
                prim_light_pmf[eid] = pmfs[ei]
            else:
                la["pmf"][eid] = pmfs[ei]

        pt = packed["prim_table"]
        pt[:P, lk.PT_EMISSION:lk.PT_EMISSION + 3] = prim_emission[:P]
        pt[:P, lk.PT_LIGHT_PMF] = prim_light_pmf[:P]
        lt = np.zeros((nl, lk.LT_COLS), np.float32)
        lt[:, lk.LT_TYPE] = la["type"]
        lt[:, lk.LT_CO:lk.LT_CO + 3] = la["co"]
        lt[:, lk.LT_DIR:lk.LT_DIR + 3] = la["dir"]
        lt[:, lk.LT_SIZE] = la["size"]
        lt[:, lk.LT_AXISU:lk.LT_AXISU + 3] = la["axisu"]
        lt[:, lk.LT_AXISV:lk.LT_AXISV + 3] = la["axisv"]
        lt[:, lk.LT_SIZEU] = la["sizeu"]
        lt[:, lk.LT_SIZEV] = la["sizev"]
        lt[:, lk.LT_STRENGTH:lk.LT_STRENGTH + 3] = la["strength"]
        lt[:, lk.LT_ANGLE] = la["angle"]
        lt[:, lk.LT_SPOT_ANGLE] = la["spot_angle"]
        lt[:, lk.LT_SPOT_SMOOTH] = la["spot_smooth"]
        lt[:, lk.LT_PMF] = la["pmf"]
        types = np.array([e[0] for e in entries], np.int32)
        ids = np.array([e[1] for e in entries], np.int32)
        out = {
            "light_dist_cdf": cdf.astype(np.float32),
            "light_dist_type": types,
            "bg_pmf": np.float32(0.0),
            "lamp_table": lt,
            "light_entries": np.stack(
                [types.astype(np.float32), ids.astype(np.float32),
                 pmfs.astype(np.float32), np.zeros(D, np.float32)], -1),
            # per-entry kinds ("tri" or the lamp type), static for the
            # sampler's branch choice (ops/light.py)
            "__light_kinds__": tuple(
                "tri" if int(e[0]) == 1 else int(la["type"][int(e[1])])
                for e in entries),
        }
        # per-entry row snapshots: the NEE pick fetches D-row tables by
        # entry index instead of the prim, object and lamp tables
        ot = packed["object_table"]
        p0 = np.maximum(np.where(types == 1, ids, 0), 0)
        le_prim = pt[np.minimum(p0, len(pt) - 1)]
        ob = np.maximum(le_prim[:, lk.PT_OBJECT].astype(np.int64), 0)
        le_obj = ot[np.minimum(ob, len(ot) - 1)]
        l0 = np.maximum(np.where(types == 1, 0, ids), 0)
        le_lamp = lt[np.minimum(l0, len(lt) - 1)]
        if not (D <= lk.ONEHOT_MAX_ROWS and np.isfinite(le_prim).all()
                and np.isfinite(le_obj).all()
                and np.isfinite(le_lamp).all()):
            raise NotImplementedError("light entry rows must be small and "
                                      "finite")
        out["le_prim_rows"] = le_prim.astype(np.float32)
        out["le_obj_rows"] = le_obj.astype(np.float32)
        out["le_lamp_rows"] = le_lamp.astype(np.float32)
        return out

    # ------------------------------------------------------------------
    def make_kernel_globals(self, device):
        """KernelGlobals on `device`: tensors under "dscene", statics
        under the JAX package's key names."""
        assert self.dscene is not None, "call device_update() first"
        ds = self.dscene
        textures = TextureStore.from_numpy(
            ds["tex_data"], ds["tex_sizes"], device,
            mips=self.image_manager.mip_slots,
            # the camera's pixel angle: the checker's footprint estimate
            pixel_angle=float(self.camera.fov) / max(
                int(self.camera.width), 1))
        return _assemble_kg(ds["arrays"], ds, self.shaders, textures,
                            [int(li.get_enum_int("light_type"))
                             for li in self.lights], device)


def _boundary_tables(shaders, prim_table, ctab, ct, motion=False):
    """Volume-boundary flags: (P,) bool per prim (its shader has a
    volume closure) and (C, ct) 0/1 float per cluster slot, the table
    K3's dual form splits its two minima by (None without cluster
    tables; motion: the rows carry a delta block). All zero without
    volume shaders."""
    shv = np.array([bool(s.has_volume) for s in shaders] or [False])
    pshader = np.clip(prim_table[:, lk.PT_SHADER].astype(np.int64), 0,
                      len(shv) - 1)
    prim_bnd = shv[pshader]
    if ctab is None:
        return prim_bnd, None
    pb = ci.prim_col(ct, motion)
    pids = ctab[:, pb:pb + ct].astype(np.int64)
    bnd = np.where(pids >= 0,
                   prim_bnd[np.clip(pids, 0, len(prim_bnd) - 1)], False)
    return prim_bnd, bnd.astype(np.float32)


def shader_statics(shaders):
    """Per-shader lists and scene features the integrator reads, under
    the JAX package's key names (models/scene.py make_kernel_globals)."""
    return {
        "shader_has_volume": [bool(s.has_volume) for s in shaders],
        "shader_volume_only": [bool(s.volume_only) for s in shaders],
        "shader_het_volume": [bool(s.has_heterogeneous_volume)
                              for s in shaders],
        # delta-tracking majorants: zero, as for every homogeneous medium
        "shader_sigma_max": np.zeros(max(len(shaders), 1), np.float32),
        "shader_vol_sampling": [s.get_enum_int("volume_sampling_method")
                                if s.has_volume else 0 for s in shaders],
        # no port node makes a surface shadow-transparent
        "shader_shadow_transparent": [False] * len(shaders),
        "features": {
            "has_glossy": any(s.has_glossy for s in shaders),
            "has_emission": any(s.has_surface_emission for s in shaders),
            # volume-only boundaries pass through as transparent
            "has_transparent": any(s.volume_only for s in shaders),
            "has_volume": any(s.has_volume for s in shaders),
            "has_subsurface": any(s.has_subsurface for s in shaders),
            "has_heterogeneous": any(s.has_heterogeneous_volume
                                     for s in shaders),
            "has_equiangular": any(
                s.has_volume
                and s.get_enum_int("volume_sampling_method") != 0
                for s in shaders),
        },
    }


def _to_tensor(a, device):
    """A host array as a tensor on `device`; uint32 bit masks become
    int32 (torch has no uint32 arithmetic)."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int32)
    return torch.tensor(a, device=device)


def _assemble_kg(arrays, ds, shaders, textures, lamp_types, device):
    return {
        "dscene": {k: _to_tensor(arrays[k], device)
                   for k in KG_ARRAYS + KG_DENSE + KG_OPTIONAL + KG_DEFORM
                   if k in arrays},
        "cam": ds["cam"],
        "kint": ds["kint"],
        "filter_table": torch.tensor(np.array(ds["filter_table"]),
                                     device=device),
        "shaders": shaders,
        "textures": textures,
        "background_shader": int(ds["background_shader"]),
        "use_brute": bool(ds["use_brute"]),
        "cluster_tris": int(ds["cluster_tris"]),
        "sc_gmax": int(ds["sc_gmax"]),
        "cluster_motion": bool(ds["cluster_motion"]),
        "has_instances": bool(ds["has_instances"]),
        "has_deform_motion": bool(ds["has_deform_motion"]),
        "deform_steps": int(ds["deform_steps"]),
        # object motion is not in the port: rays carry a time for the
        # deforming meshes only
        "has_motion": bool(ds["has_deform_motion"]),
        "film_transparent": False,
        "num_area_lamps": lamp_types.count(light_mod.LIGHT_AREA),
        "lamp_types": lamp_types,
        "light_tree": None,
        "light_kinds": ds["light_kinds"],
        "volume_stack_depth": int(ds["volume_stack_depth"]),
        **shader_statics(shaders),
    }


def estimate_constant_emission(shader):
    """Constant-fold the emission reaching the surface output."""
    g = shader.graph
    link = g.links.get((id(g.output_node), "surface"))
    if link is None:
        return None
    node = link[0]
    if isinstance(node, (sn.EmissionNode, sn.BackgroundNode)):
        if (g.links.get((id(node), "color")) is None
                and g.links.get((id(node), "strength")) is None):
            return np.asarray(node.color, np.float32) * float(node.strength)
        return np.ones(3, np.float32)
    return None


# ----------------------------------------------------------------------
# JAX kernel globals -> port kernel globals (the renderer's counterpart
# of a weight converter): the port can render a scene compiled by the JAX
# package, bit for bit as its own compile of that scene
# (tests/test_torch_render.py, tests/test_torch_scene.py)

# statics the JAX package sets that the port has no path for: a scene
# that turns one on cannot be rendered by the port (has_motion without
# has_deform_motion is object motion, refused in kg_from_jax)
_UNPORTED_FLAGS = ("has_shadow_catcher",
                   "film_transparent", "light_passes", "aux_passes",
                   "sorted_shading")


def _convert_shader(jshader):
    """Rebuild a JAX-package shader from port nodes (same class names,
    same socket values, same links)."""
    g = ShaderGraph()
    nodes = {id(jshader.graph.output_node): g.output_node}
    for jn in jshader.graph.nodes:
        if jn is jshader.graph.output_node:
            continue
        cls = sn.NODE_CLASSES.get(type(jn).__name__)
        if cls is None:
            raise NotImplementedError(
                f"shader node {type(jn).__name__} is not ported")
        node = cls(jn.name)
        for sname in cls._socket_map:
            node.set(sname, getattr(jn, sname))
        if isinstance(node, sn.ImageTextureNode):
            node.image, node.slot = jn.image, jn.slot
        nodes[id(jn)] = g.add(node)
    for (to_id, to_sock), (jfrom, from_sock) in jshader.graph.links.items():
        g.links[(id(nodes[to_id]), to_sock)] = (nodes[id(jfrom)],
                                                from_sock)
    sh = Shader(jshader.name, g)
    for sname in Shader._socket_map:
        sh.set(sname, getattr(jshader, sname))
    sh.slot = jshader.slot
    return sh.analyze()


def kg_from_jax(kg_jax, device):
    """Convert `Scene.make_kernel_globals(device_put=False)` of the JAX
    package into port KernelGlobals on `device`."""
    for k in _UNPORTED_FLAGS:
        if kg_jax.get(k):
            raise NotImplementedError(f"kg['{k}'] is not ported")
    if kg_jax.get("light_tree") is not None:
        raise NotImplementedError("the light tree is not ported")
    if kg_jax.get("has_motion") and not kg_jax.get("has_deform_motion"):
        raise NotImplementedError("object motion is not ported")
    # the JAX package keeps tri_verts_world_t1 in every scene (the static
    # triangles where nothing deforms); the port only where it deforms
    keys = KG_ARRAYS + KG_DENSE + KG_OPTIONAL + (
        KG_DEFORM if kg_jax.get("has_deform_motion") else ())
    arrays = {k: np.asarray(kg_jax["dscene"][k])
              for k in keys if k in kg_jax["dscene"]}
    ds = {"cam": {k: np.asarray(v) for k, v in kg_jax["cam"].items()},
          "kint": dict(kg_jax["kint"]),
          "filter_table": np.asarray(kg_jax["filter_table"]),
          "background_shader": kg_jax["background_shader"],
          "use_brute": kg_jax["use_brute"],
          "has_instances": kg_jax.get("has_instances", False),
          "has_deform_motion": kg_jax.get("has_deform_motion", False),
          "deform_steps": kg_jax.get("deform_steps", 1),
          "cluster_tris": kg_jax["cluster_tris"],
          "cluster_motion": kg_jax.get("cluster_motion", False),
          "sc_gmax": kg_jax.get("sc_gmax", 0),
          "light_kinds": kg_jax["light_kinds"],
          "volume_stack_depth": kg_jax["volume_stack_depth"]}
    shaders = [_convert_shader(s) for s in kg_jax["shaders"]]
    jt = kg_jax["textures"]
    textures = TextureStore.from_numpy(
        np.asarray(jt.data), jt.sizes, device, mips=getattr(jt, "mips", {}),
        pixel_angle=getattr(jt, "pixel_angle", None))
    kg = _assemble_kg(arrays, ds, shaders, textures,
                      list(kg_jax.get("lamp_types") or []), device)
    kg["fused_nee"] = bool(kg_jax.get("fused_nee", False))
    return kg
