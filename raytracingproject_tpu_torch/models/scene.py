"""Scene container and host compile (JAX counterpart:
raytracingproject_tpu/models/scene.py `Scene.device_update` +
`make_kernel_globals`).

The card has no JAX, so the port owns its host compile. It is numpy
only and covers the port's scenes: static single-user meshes baked to
world space, the SAH BVH build and cluster cut (the port's own
bvh/build.py and bvh/clusters.py), the cluster tables, the wide
prim/object tables, the all-triangle mesh light distribution, and for
volume scenes the volume-boundary tables (prim_is_boundary,
cluster_boundary), the per-shader volume lists and shadow-invisible
volume-only objects. Every array is built with the same numpy
operations in the same order as the JAX package, so the tables come out
bit-identical (tests/test_torch_scene.py,
tests/test_torch_volume_render.py). Instancing, motion, hair,
subdivision, displacement, lamps, background maps, the light tree and
scenes of 2,048 prims or more (the JAX package's C++ BVH builder) raise
NotImplementedError. A scene of at most 1,024 prims records use_brute
(the JAX package's dense-sweep choice) but still packs its clusters; only
the dense dispatch itself raises.

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
from raytracingproject_tpu_torch.models import shader_nodes as sn
from raytracingproject_tpu_torch.models.camera import Camera
from raytracingproject_tpu_torch.models.film import Film
from raytracingproject_tpu_torch.models.integrator import Integrator
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
AUTO_FLATTEN_MAX_PRIMS = 16384

# kernel-globals arrays the port's render reads
KG_ARRAYS = ("prim_table", "object_table", "cluster_bounds",
             "cluster_table", "cluster_boundary", "prim_is_boundary",
             "light_dist_type", "light_dist_cdf", "light_entries",
             "le_prim_rows", "le_obj_rows", "bg_pmf")


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


class Background:
    """World settings: the background shader (None = black, no entry in
    the light distribution) and film transparency."""

    def __init__(self):
        self.shader = None
        self.transparent = False


class Scene:
    def __init__(self):
        self.camera = Camera("camera")
        self.film = Film("film")
        self.integrator = Integrator("integrator")
        self.background = Background()
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

    # ------------------------------------------------------------------
    def device_update(self):
        """Host compile: shaders -> geometry/clusters -> lights ->
        camera/film/integrator (the JAX package's order)."""
        if self.lights:
            raise NotImplementedError("lamps are not ported (mesh lights "
                                      "only)")
        if self.background.shader is not None:
            raise NotImplementedError("background shaders are not ported")
        if self.background.transparent:
            raise NotImplementedError("transparent film is not ported")
        for slot, sh in enumerate(self.shaders):
            sh.slot = slot
            sh.analyze()
        packed = self._pack_geometry()
        lightd = self._pack_lights(packed)
        arrays = dict(packed)
        arrays.update(lightd)
        arrays["prim_is_boundary"], arrays["cluster_boundary"] = \
            _boundary_tables(self.shaders, arrays["prim_table"],
                             arrays["cluster_table"],
                             packed["__cluster_tris__"])
        self.dscene = {
            "arrays": {k: arrays[k] for k in KG_ARRAYS},
            "cam": self.camera.update(),
            "kint": self.integrator.kernel_record(),
            "filter_table": self.film.build_filter_table(),
            "background_shader": (self.default_background.slot
                                  if self.default_background in self.shaders
                                  else -1),
            "use_brute": packed["__use_brute__"],
            "cluster_tris": packed["__cluster_tris__"],
            "light_kinds": lightd["__light_kinds__"],
            "volume_stack_depth": int(self.integrator.volume_stack_depth),
        }
        return self.dscene

    # ------------------------------------------------------------------
    def _pack_geometry(self):
        objects = self.objects
        nobj = max(len(objects), 1)
        geom_users = {}
        for oi, obj in enumerate(objects):
            if obj.use_motion:
                raise NotImplementedError("object motion is not ported")
            geom_users.setdefault(id(obj.geometry), []).append(oi)
        total_flat = sum(o.geometry.num_triangles for o in objects)
        if total_flat > AUTO_FLATTEN_MAX_PRIMS and any(
                len(u) > 1 for u in geom_users.values()):
            raise NotImplementedError("instanced geometry is not ported")

        tri_verts, tri_vnormal, tri_uv = [], [], []
        prim_shader, prim_smooth, prim_object = [], [], []
        for oi, obj in enumerate(objects):
            mesh = obj.geometry
            world_tfm = np.asarray(obj.transform, np.float32)
            v = mesh.verts_array
            t = mesh.triangles_array
            if len(t) == 0:
                continue
            vn_attr = mesh.attribute_get("std_vertex_normal")
            vn = mesh.compute_vertex_normals() if vn_attr is None \
                else vn_attr.data
            v = tfm.transform_point(world_tfm, v)
            itt = np.linalg.inv(tfm.to_4x4(world_tfm))[:3, :3].T
            vn = vn @ itt.T
            ln = np.linalg.norm(vn, axis=-1, keepdims=True)
            vn = vn / np.maximum(ln, 1e-12)
            tri_verts.append(v[t])
            tri_vnormal.append(vn[t])
            uv_attr = mesh.attribute_get("std_uv")
            if uv_attr is not None:
                if uv_attr.element == "corner":
                    tri_uv.append(uv_attr.data.reshape(-1, 3, 2)[: len(t)])
                else:
                    tri_uv.append(uv_attr.data[t])
            else:
                tri_uv.append(np.tile(
                    np.array([[0, 0], [1, 0], [1, 1]], np.float32),
                    (len(t), 1, 1)))
            prim_shader.append(np.array(
                [self._shader_slot(mesh, s)
                 for s in np.asarray(mesh.shader, np.int32)], np.int32))
            prim_smooth.append(np.asarray(mesh.smooth, bool))
            prim_object.append(np.full(len(t), oi, np.int32))

        def cat(lst, shape_tail, dtype=np.float32):
            if lst:
                return np.concatenate(lst).astype(dtype)
            return np.zeros((0,) + shape_tail, dtype)

        static_verts = cat(tri_verts, (3, 3))
        P = len(static_verts)
        if P == 0:
            raise NotImplementedError("empty scenes are not ported")
        lo, hi = static_verts.min(1), static_verts.max(1)
        sb = bvh_build.build_bvh(lo, hi)
        order = sb.prim_order
        packed = {
            "tri_verts": static_verts[order],
            "tri_vnormal": cat(tri_vnormal, (3, 3))[order],
            "tri_uv": cat(tri_uv, (3, 2))[order],
            "prim_shader": cat(prim_shader, (), np.int32)[order],
            "prim_smooth": cat(prim_smooth, (), bool)[order],
            "prim_object_packed": cat(prim_object, (), np.int32)[order],
        }

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
            obj_itfm_gen[oi] = tfm.inverse(
                np.asarray(obj.transform, np.float32))
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

        # ---- cluster tables ----
        if P < CLUSTER_MIN_PRIMS:
            raise NotImplementedError(
                f"{P} prims: the dense sweep (K1) path is not ported")
        for ct_size in (16, 32, 64):
            cuts = cl_mod.cut_clusters(sb.children, ct_size)
            if len(cuts) <= CLUSTER_MAX_SINGLE_LEVEL:
                break
        else:
            raise NotImplementedError(
                "two-level cluster tables (K5) are not ported")
        tv = packed["tri_verts"]
        po = packed["prim_object_packed"]
        cds = []
        for (s, c) in cuts:
            verts = tv[s:s + c]
            objv = po[s:s + c]
            allv = verts.reshape(-1, 3)
            cds.append({"verts": verts, "prim": np.arange(s, s + c),
                        "obj": objv,
                        "vis": obj_visibility[np.maximum(objv, 0)],
                        "lo": allv.min(0), "hi": allv.max(0)})
        cb, ctab, ct_used = ci.pack_cluster_table(cds)
        packed["cluster_bounds"] = cb
        packed["cluster_table"] = ctab
        packed["__cluster_tris__"] = ct_used
        packed["__use_brute__"] = P <= BRUTE_VS_CLUSTER_PRIMS

        # ---- wide lookup tables (ops/lookup.py layout) ----
        pt = np.zeros((P, lk.PT_COLS), np.float32)
        pt[:, lk.PT_V0:lk.PT_V0 + 9] = packed["tri_verts"].reshape(P, 9)
        pt[:, lk.PT_VN:lk.PT_VN + 9] = packed["tri_vnormal"].reshape(P, 9)
        pt[:, lk.PT_UV:lk.PT_UV + 6] = packed["tri_uv"].reshape(P, 6)
        pt[:, lk.PT_SHADER] = packed["prim_shader"]
        pt[:, lk.PT_SMOOTH] = packed["prim_smooth"]
        pt[:, lk.PT_OBJECT] = packed["prim_object_packed"]
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
        """Flat emission distribution over emissive triangles."""
        entries = []  # (type 1 = tri, prim id, power)
        prim_shader = packed["prim_shader"]
        prim_obj = packed["prim_object_packed"]
        tri_verts = packed["tri_verts"]
        P = len(prim_shader)
        prim_emission = np.zeros((P, 3), np.float32)
        emis_by_slot = {}
        for sh in self.shaders:
            est = estimate_constant_emission(sh)
            if est is not None and np.any(est > 0):
                emis_by_slot[sh.slot] = est
        for slot, est in emis_by_slot.items():
            idxs = np.nonzero((prim_shader == slot) & (prim_obj >= 0))[0]
            prim_emission[idxs] = est
            for pi in idxs:
                v = tri_verts[pi]
                area = 0.5 * np.linalg.norm(
                    np.cross(v[1] - v[0], v[2] - v[0]))
                lum = float(0.2126 * est[0] + 0.7152 * est[1]
                            + 0.0722 * est[2])
                entries.append((1, int(pi), max(lum * area * np.pi, 1e-12)))
        D = len(entries)
        if D == 0:
            raise NotImplementedError("scenes without emitters are not "
                                      "ported")
        powers = np.array([e[2] for e in entries], np.float64)
        cdf = np.concatenate([[0.0], np.cumsum(powers / powers.sum())])
        cdf[-1] = 1.0
        pmfs = (powers / powers.sum()).astype(np.float32)
        prim_light_pmf = np.zeros(max(P, 1), np.float32)
        for ei, (_etype, eid, _p) in enumerate(entries):
            prim_light_pmf[eid] = pmfs[ei]

        pt = packed["prim_table"]
        pt[:P, lk.PT_EMISSION:lk.PT_EMISSION + 3] = prim_emission[:P]
        pt[:P, lk.PT_LIGHT_PMF] = prim_light_pmf[:P]
        types = np.array([e[0] for e in entries], np.int32)
        ids = np.array([e[1] for e in entries], np.int32)
        out = {
            "light_dist_cdf": cdf.astype(np.float32),
            "light_dist_type": types,
            "bg_pmf": np.float32(0.0),
            "light_entries": np.stack(
                [types.astype(np.float32), ids.astype(np.float32),
                 pmfs.astype(np.float32), np.zeros(D, np.float32)], -1),
            "__light_kinds__": tuple("tri" for _ in entries),
        }
        # per-entry row snapshots: the NEE pick fetches D-row tables by
        # entry index instead of the (P, 36) prim table
        ot = packed["object_table"]
        le_prim = pt[np.minimum(np.maximum(ids, 0), len(pt) - 1)]
        ob = np.maximum(le_prim[:, lk.PT_OBJECT].astype(np.int64), 0)
        le_obj = ot[np.minimum(ob, len(ot) - 1)]
        if not (D <= lk.ONEHOT_MAX_ROWS and np.isfinite(le_prim).all()
                and np.isfinite(le_obj).all()):
            raise NotImplementedError("light entry rows must be small and "
                                      "finite")
        out["le_prim_rows"] = le_prim.astype(np.float32)
        out["le_obj_rows"] = le_obj.astype(np.float32)
        return out

    # ------------------------------------------------------------------
    def make_kernel_globals(self, device):
        """KernelGlobals on `device`: tensors under "dscene", statics
        under the JAX package's key names."""
        assert self.dscene is not None, "call device_update() first"
        ds = self.dscene
        return _assemble_kg(ds["arrays"], ds, self.shaders, device)


def _boundary_tables(shaders, prim_table, ctab, ct):
    """Volume-boundary flags: (P,) bool per prim (its shader has a
    volume closure) and (C, ct) 0/1 float per cluster slot, the table
    K3's dual form splits its two minima by. All zero without volume
    shaders."""
    shv = np.array([bool(s.has_volume) for s in shaders] or [False])
    pshader = np.clip(prim_table[:, lk.PT_SHADER].astype(np.int64), 0,
                      len(shv) - 1)
    prim_bnd = shv[pshader]
    pb = ci.META_COLS + 9 * ct
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


def _assemble_kg(arrays, ds, shaders, device):
    return {
        "dscene": {k: torch.tensor(np.array(arrays[k]), device=device)
                   for k in KG_ARRAYS},
        "cam": ds["cam"],
        "kint": ds["kint"],
        "filter_table": torch.tensor(np.array(ds["filter_table"]),
                                     device=device),
        "shaders": shaders,
        "background_shader": int(ds["background_shader"]),
        "use_brute": bool(ds["use_brute"]),
        "cluster_tris": int(ds["cluster_tris"]),
        "cluster_motion": False,
        "has_instances": False,
        "film_transparent": False,
        "num_area_lamps": 0,
        "lamp_types": [],
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

# statics the JAX package sets that this slice has no path for: a
# scene that turns one on cannot be rendered by the port
_UNPORTED_FLAGS = ("has_instances", "cluster_motion", "has_motion",
                   "has_deform_motion", "has_shadow_catcher",
                   "film_transparent", "light_passes", "aux_passes",
                   "fused_nee", "sorted_shading")


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
    if kg_jax.get("lamp_types") or kg_jax.get("light_tree") is not None:
        raise NotImplementedError("lamps and the light tree are not ported")
    arrays = {k: np.asarray(kg_jax["dscene"][k]) for k in KG_ARRAYS}
    ds = {"cam": {k: np.asarray(v) for k, v in kg_jax["cam"].items()},
          "kint": dict(kg_jax["kint"]),
          "filter_table": np.asarray(kg_jax["filter_table"]),
          "background_shader": kg_jax["background_shader"],
          "use_brute": kg_jax["use_brute"],
          "cluster_tris": kg_jax["cluster_tris"],
          "light_kinds": kg_jax["light_kinds"],
          "volume_stack_depth": kg_jax["volume_stack_depth"]}
    shaders = [_convert_shader(s) for s in kg_jax["shaders"]]
    return _assemble_kg(arrays, ds, shaders, device)
