"""Triangle meshes and their generators (JAX counterpart:
raytracingproject_tpu/models/mesh.py).

Host-side numpy until the scene compile packs them (models/scene.py).
Deforming motion is the attribute "std_motion_vertex_position": one
shutter-close position per vertex (V, 3), or uniform steps after shutter
open (S-1, V, 3). Subdivision and hair are not part of the port.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.models.node import Node, SocketType as S

ATTR_STD_UV = "std_uv"
ATTR_STD_VERTEX_NORMAL = "std_vertex_normal"
ATTR_STD_MOTION_VERTEX_POSITION = "std_motion_vertex_position"
ATTR_ELEMENT_VERTEX = "vertex"
ATTR_ELEMENT_CORNER = "corner"


class Attribute:
    """Named geometry attribute."""

    def __init__(self, name, element, data):
        self.name = name
        self.element = element
        self.data = np.asarray(data, np.float32)


class Mesh(Node):
    SOCKETS = [
        S("use_motion_blur", S.BOOLEAN, False),
        S("motion_steps", S.UINT, 3),
        S("verts", S.POINT_ARRAY, np.zeros((0, 3), np.float32)),
        S("triangles", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("shader", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("smooth", S.BOOLEAN_ARRAY, np.zeros((0,), bool)),
    ]

    def __init__(self, name="", **kwargs):
        super().__init__(name, **kwargs)
        self.used_shaders = []
        self.attributes = {}

    def attribute_set(self, name, element, data):
        self.attributes[name] = Attribute(name, element, data)

    def attribute_get(self, name):
        return self.attributes.get(name)

    def set_mesh(self, verts, triangles, shader=None, smooth=None):
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
        ntris = len(triangles)
        self.set("verts", verts)
        self.set("triangles", triangles.reshape(-1))
        self.set("shader", np.zeros(ntris, np.int32) if shader is None
                 else np.broadcast_to(np.asarray(shader, np.int32),
                                      (ntris,)).copy())
        self.set("smooth", np.zeros(ntris, bool) if smooth is None
                 else np.broadcast_to(np.asarray(smooth, bool),
                                      (ntris,)).copy())

    @property
    def num_triangles(self):
        return len(self.triangles) // 3

    @property
    def verts_array(self):
        return np.asarray(self.verts, np.float32).reshape(-1, 3)

    @property
    def triangles_array(self):
        return np.asarray(self.triangles, np.int32).reshape(-1, 3)

    def compute_bounds(self):
        v = self.verts_array
        if len(v) == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return v.min(0), v.max(0)

    def compute_vertex_normals(self):
        """Area-weighted vertex normals."""
        v = self.verts_array
        t = self.triangles_array
        n = np.zeros_like(v)
        fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        for i in range(3):
            np.add.at(n, t[:, i], fn)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), [0.0, 0.0, 1.0])
        self.attribute_set(ATTR_STD_VERTEX_NORMAL, ATTR_ELEMENT_VERTEX, n)
        return n


def make_plane_mesh(p0, e0, e1, shader=0, name="plane"):
    """Quad from a corner and two edge vectors."""
    p0, e0, e1 = (np.asarray(x, np.float32) for x in (p0, e0, e1))
    verts = np.stack([p0, p0 + e0, p0 + e0 + e1, p0 + e1])
    m = Mesh(name)
    m.set_mesh(verts, [[0, 1, 2], [0, 2, 3]], shader=shader)
    return m


def make_box_mesh(lo, hi, shader=0, name="box", inside=False):
    """Axis-aligned box; `inside=True` flips windings."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    verts = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]], np.float32)
    quads = np.array([
        [3, 2, 1, 0], [4, 5, 6, 7], [0, 1, 5, 4],
        [2, 3, 7, 6], [4, 7, 3, 0], [1, 2, 6, 5]], np.int32)
    if inside:
        quads = quads[:, ::-1]
    m = Mesh(name)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], 0)
    m.set_mesh(verts, tris, shader=shader)
    return m


def make_sphere_mesh(center, radius, shader=0, nlat=16, nlon=32,
                     name="sphere"):
    """UV-sphere triangulation with spherical vertex uvs."""
    center = np.asarray(center, np.float32)
    lat = np.linspace(0, np.pi, nlat + 1)
    lon = np.linspace(0, 2 * np.pi, nlon, endpoint=False)
    verts = []
    for th in lat:
        for ph in lon:
            verts.append(center + radius * np.array(
                [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                 np.cos(th)]))
    verts = np.asarray(verts, np.float32)
    tris = []
    for i in range(nlat):
        for j in range(nlon):
            a = i * nlon + j
            b = i * nlon + (j + 1) % nlon
            c = (i + 1) * nlon + j
            d = (i + 1) * nlon + (j + 1) % nlon
            if i > 0:
                tris.append([a, c, b])
            if i < nlat - 1:
                tris.append([b, c, d])
    m = Mesh(name)
    m.set_mesh(verts, np.asarray(tris, np.int32), shader=shader)
    rel = (verts - center) / max(radius, 1e-9)
    u = 0.5 + np.arctan2(rel[:, 1], rel[:, 0]) / (2 * np.pi)
    vv = 0.5 + np.arcsin(np.clip(rel[:, 2], -1, 1)) / np.pi
    m.attribute_set(ATTR_STD_UV, ATTR_ELEMENT_VERTEX, np.stack([u, vv], -1))
    return m
