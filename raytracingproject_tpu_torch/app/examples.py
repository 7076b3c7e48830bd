"""Example scenes (JAX counterpart: raytracingproject_tpu/app/examples.py).

Each scene is built as the JAX package builds it, object for object and
shader for shader, so both host compiles produce the same tables:
`cornell_box` (with the two boxes the cornell_diffuse configuration, 36
prims; with spheres="glossy" the glossy_nee_mis configuration),
`volume_sss_scene` (the volume_sss configuration: a homogeneous smoke box
and a random-walk SSS sphere in the Cornell box), `dof_motion_scene` (the
dof_motion_adaptive configuration: the glossy box seen through a
six-bladed lens by a moving camera, rendered with adaptive sampling) and
`instanced_scene`
(with grid=8 the big_instanced configuration: 64 instances of one
image-textured sphere on a checkered ground plane under a distant sun and
a constant sky; at its default grid=4 the textured_instanced
configuration, 16 of them compiled flattened; at grid=6, and at grid=5
with nlat=15, instanced with single-level tables), and the two deforming
scenes: `glossy_deform_scene` (the glossy box whose mirror sphere grows
and moves over the shutter: motion cluster rows, K2 and K3),
`glossy_deform_big_scene` (the same with a 41,580-triangle mirror sphere:
two-level motion tables, K5) and `cornell_deform_scene` (the Cornell box
whose short box rises and slides on a three-step path: the dense sweep
K1's deform modes). Variants that need
unported features (glass spheres, an area lamp) raise
NotImplementedError.

Dispatch flags (kg.update(...) after make_kernel_globals):
VOLUME_SSS_DISPATCH holds the intersection flags the JAX package's
benchmark pins for volume_sss, the tile-shared cluster walk (K4) and the
occlusion walk (K3); without them its 1,008 prims select the dense sweep
(K1), the host compile's own choice. BIG_INSTANCED_ONEHOT2 opts the
two-level scene into the per-lane inner walk (K6) in place of K5.
FUSED_NEE opts a scene into fused-NEE mode: one union walk (K7) per
bounce answers the shadow test and the next closest hit; GLOSSY_FUSED is
it for the glossy Cornell box. GLOSSY_DEFORM_TILE sends glossy_deform's
closest hits to the tile-shared walk (K4) in place of K2, the JAX
package's dispatch without its one-hot tables. GLOSSY_DEFORM_BIG_ONEHOT2
opts glossy_deform_big into K6 in place of K5.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.models import shader_nodes as sn
from raytracingproject_tpu_torch.models.light import Light
from raytracingproject_tpu_torch.models.mesh import (
    make_box_mesh, make_plane_mesh, make_sphere_mesh)
from raytracingproject_tpu_torch.models.object import Object
from raytracingproject_tpu_torch.models.scene import Scene
from raytracingproject_tpu_torch.models.shader import Shader, ShaderGraph
from raytracingproject_tpu_torch.utils import transform as tfm


def diffuse_shader(name, color):
    g = ShaderGraph()
    d = g.add(sn.DiffuseBsdfNode(name + "_bsdf", color=color))
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader(name, g)


def glossy_shader(name, color, roughness=0.1):
    g = ShaderGraph()
    d = g.add(sn.GlossyBsdfNode(name + "_bsdf", color=color,
                                roughness=roughness))
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader(name, g)


def emission_shader(name, color, strength):
    g = ShaderGraph()
    e = g.add(sn.EmissionNode(name + "_emit", color=color,
                              strength=strength))
    g.connect(e, "emission", g.output_node, "surface")
    return Shader(name, g)


def cornell_box(width=256, height=256, spp=64, light_mode="mesh",
                spheres=None):
    """Classic Cornell box. light_mode: 'mesh' (emissive quad).
    spheres: None (two boxes) | 'diffuse' | 'glossy'."""
    if light_mode != "mesh":
        raise NotImplementedError("area-lamp lighting is not ported")
    if spheres not in (None, "diffuse", "glossy"):
        raise NotImplementedError(f"spheres='{spheres}' is not ported")
    scene = Scene()
    scene.camera.set("matrix", tfm.look_at((278, -800, 273), (278, 0, 273),
                                           (0, 0, 1)))
    scene.camera.set("fov", 0.686)
    scene.camera.set("width", width)
    scene.camera.set("height", height)

    white = diffuse_shader("white", (0.73, 0.73, 0.73))
    red = diffuse_shader("red", (0.65, 0.05, 0.05))
    green = diffuse_shader("green", (0.12, 0.45, 0.15))
    for s in (white, red, green):
        scene.add_shader(s)

    def add_mesh(mesh, shaders, name):
        mesh.used_shaders = shaders
        return scene.add_object(Object(name, mesh))

    add_mesh(make_plane_mesh((0, 0, 0), (556, 0, 0), (0, 556, 0), 0,
                             "floor"), [white], "floor")
    add_mesh(make_plane_mesh((0, 0, 548.8), (0, 556, 0), (556, 0, 0), 0,
                             "ceil"), [white], "ceil")
    add_mesh(make_plane_mesh((0, 556, 0), (556, 0, 0), (0, 0, 548.8), 0,
                             "back"), [white], "back")
    add_mesh(make_plane_mesh((0, 0, 0), (0, 556, 0), (0, 0, 548.8), 0,
                             "right"), [green], "right")
    add_mesh(make_plane_mesh((556, 0, 0), (0, 0, 548.8), (0, 556, 0), 0,
                             "left"), [red], "left")

    if spheres is None:
        add_mesh(make_box_mesh((130, 65, 0), (295, 230, 165), 0, "short"),
                 [white], "short_box")
        add_mesh(make_box_mesh((265, 296, 0), (430, 461, 330), 0, "tall"),
                 [white], "tall_box")
    else:
        mat1 = {"diffuse": white,
                "glossy": glossy_shader("mirror", (0.95, 0.95, 0.95),
                                        0.05)}[spheres]
        scene.add_shader(mat1)
        s1 = make_sphere_mesh((185, 170, 90), 90, 0, name="sphere1")
        s2 = make_sphere_mesh((370, 350, 90), 90, 0, name="sphere2")
        s1.set("smooth", np.ones(s1.num_triangles, bool))
        s2.set("smooth", np.ones(s2.num_triangles, bool))
        add_mesh(s1, [mat1], "sphere1")
        add_mesh(s2, [white], "sphere2")

    lshader = emission_shader("light", (1.0, 0.88, 0.68), 18.0)
    scene.add_shader(lshader)
    add_mesh(make_plane_mesh((213, 227, 548.7), (130, 0, 0), (0, 105, 0), 0,
                             "light"), [lshader], "light")

    scene.integrator.set("aa_samples", spp)
    scene.integrator.set("max_bounce", 4)
    return scene


def dof_motion_scene(width=256, height=256, spp=32):
    """The dof_motion_adaptive configuration: the glossy Cornell box
    through a 12-unit six-bladed aperture focused at 900, the camera
    moving 25 units along world x over the shutter, and adaptive sampling
    (threshold 0.02). Only the camera moves: the scene's tables are the
    glossy box's."""
    scene = cornell_box(width, height, spp, spheres="glossy")
    scene.camera.set("aperturesize", 12.0)
    scene.camera.set("focaldistance", 900.0)
    scene.camera.set("blades", 6)
    scene.camera.set("use_motion", True)
    base = np.asarray(scene.camera.matrix, np.float32)
    shift = tfm.compose(tfm.translate(25, 0, 0), base)
    scene.camera.set("motion_start", base)
    scene.camera.set("motion_end", shift)
    scene.integrator.set("adaptive_threshold", 0.02)
    scene.integrator.set("adaptive_min_samples", max(spp // 4, 4))
    return scene


def volume_shader(name, color=(0.8, 0.8, 0.8), density=1.0, anisotropy=0.0,
                  absorption=(1.0, 1.0, 1.0)):
    """Volume-only material (its surface is a transparent boundary)."""
    g = ShaderGraph()
    v = g.add(sn.PrincipledVolumeNode(
        name + "_vol", color=color, density=density, anisotropy=anisotropy,
        absorption_color=absorption))
    g.connect(v, "volume", g.output_node, "volume")
    return Shader(name, g)


def smoke_cornell(width=128, height=128, spp=32, density=0.01,
                  anisotropy=0.3):
    """Cornell box with a homogeneous scattering medium filling a box."""
    scene = cornell_box(width, height, spp)
    vol = volume_shader("smoke", color=(0.8, 0.8, 0.8), density=density,
                        anisotropy=anisotropy)
    scene.add_shader(vol)
    box = make_box_mesh((100, 100, 50), (456, 456, 400), 0, "smoke_box")
    box.used_shaders = [vol]
    scene.add_object(Object("smoke", box))
    scene.integrator.set("max_bounce", 6)
    scene.integrator.set("volume_samples", 1)
    return scene


def sss_shader(name, color=(0.9, 0.3, 0.2), radius=(10.0, 5.0, 3.0),
               scale=1.0):
    g = ShaderGraph()
    s = g.add(sn.SubsurfaceScatteringNode(
        name + "_sss", color=color, radius=radius, scale=scale))
    g.connect(s, "bssrdf", g.output_node, "surface")
    return Shader(name, g)


VOLUME_SSS_DISPATCH = {"use_brute": False, "pallas_clusters": True,
                       "pallas_onehot": False, "pallas_occlusion": True}
BIG_INSTANCED_ONEHOT2 = {"pallas_onehot2": True}
FUSED_NEE = {"fused_nee": True}
GLOSSY_FUSED = FUSED_NEE
GLOSSY_DEFORM_TILE = {"pallas_onehot": False}
GLOSSY_DEFORM_BIG_ONEHOT2 = {"pallas_onehot2": True}
# the mirror sphere of glossy_deform_big_scene: 41,580 triangles
BIG_SPHERE = {"nlat": 100, "nlon": 210}


def find_mesh(scene, name):
    """The geometry of the scene's object called `name`."""
    return next(o.geometry for o in scene.objects if o.name == name)


def glossy_deform_path(verts):
    """The mirror sphere's shutter-close vertices: scaled by 1.2 about
    its centre (185, 170, 90), then moved by (60, 0, 30) (float32)."""
    c = np.array([185.0, 170.0, 90.0], np.float32)
    return ((verts - c) * np.float32(1.2) + c
            + np.array([60.0, 0.0, 30.0], np.float32)).astype(np.float32)


def cornell_deform_path(verts):
    """The short box's three-step path after shutter open, (2, V, 3):
    raised by 80 at mid-shutter, then moved by 60 along x at close."""
    return np.stack([verts + np.array([0.0, 0.0, 80.0], np.float32),
                     verts + np.array([60.0, 0.0, 0.0], np.float32)]
                    ).astype(np.float32)


def glossy_deform_scene(width=256, height=256, spp=64):
    """The glossy Cornell box (1,932 prims) with its mirror sphere
    deforming over the shutter (a two-step path, glossy_deform_path): the
    host compile packs motion cluster rows, 179 clusters x 15; K2 for
    every closest hit, K3 for every shadow test."""
    scene = cornell_box(width, height, spp, spheres="glossy")
    mesh = find_mesh(scene, "sphere1")
    mesh.attribute_set("std_motion_vertex_position", "vertex",
                       glossy_deform_path(mesh.verts_array))
    return scene


def glossy_big_scene(width=256, height=256, spp=64):
    """The glossy Cornell box with its mirror sphere rebuilt finer
    (make_sphere_mesh at BIG_SPHERE: 41,580 smooth triangles, 42,552
    prims in all), static: glossy_deform_big_scene at shutter open, whose
    tables its motion tables equal at time 0."""
    scene = cornell_box(width, height, spp, spheres="glossy")
    obj = next(o for o in scene.objects if o.name == "sphere1")
    mesh = make_sphere_mesh((185, 170, 90), 90, 0, name="sphere1",
                            **BIG_SPHERE)
    mesh.set("smooth", np.ones(mesh.num_triangles, bool))
    mesh.used_shaders = obj.geometry.used_shaders
    obj.geometry = mesh
    return scene


def glossy_deform_big_scene(width=256, height=256, spp=64):
    """glossy_big_scene with its mirror sphere on glossy_deform_path:
    the ct=64 cut passes the single-level cap, so the host compile packs
    two-level motion tables, 936 clusters x 64 in 25 superclusters (gmax
    64); K5 for every closest hit and shadow test (K6 under
    GLOSSY_DEFORM_BIG_ONEHOT2)."""
    scene = glossy_big_scene(width, height, spp)
    mesh = find_mesh(scene, "sphere1")
    mesh.attribute_set("std_motion_vertex_position", "vertex",
                       glossy_deform_path(mesh.verts_array))
    return scene


def cornell_deform_scene(width=256, height=256, spp=64):
    """The Cornell box with its two boxes (36 prims), the short box on
    a three-step path (cornell_deform_path): deform_steps 3, no cluster
    tables, the dense sweep K1 with the hat-weighted two-segment lerp for
    every closest hit and shadow test."""
    scene = cornell_box(width, height, spp)
    mesh = find_mesh(scene, "short_box")
    mesh.attribute_set("std_motion_vertex_position", "vertex",
                       cornell_deform_path(mesh.verts_array))
    return scene


def volume_sss_scene(width=256, height=256, spp=32, density=0.004):
    """The volume_sss configuration: homogeneous smoke in a box and a
    random-walk SSS sphere in one Cornell box (1,008 prims)."""
    scene = smoke_cornell(width, height, spp, density=density)
    mat = sss_shader("wax", color=(0.8, 0.5, 0.3),
                     radius=(40.0, 20.0, 10.0))
    scene.add_shader(mat)
    s1 = make_sphere_mesh((430, 120, 100), 100, 0, nlat=16, nlon=32,
                          name="sss_sphere")
    s1.set("smooth", np.ones(s1.num_triangles, bool))
    s1.used_shaders = [mat]
    scene.add_object(Object("sss_sphere", s1))
    scene.integrator.set("max_bounce", 8)
    scene.integrator.set("max_transmission_bounce", 16)
    return scene


def background_shader(name, color, strength=1.0):
    g = ShaderGraph()
    b = g.add(sn.BackgroundNode(name + "_bg", color=color, strength=strength))
    g.connect(b, "background", g.output_node, "surface")
    return Shader(name, g)


def checker_shader(name, scale=4.0, c1=(0.8, 0.8, 0.8), c2=(0.15, 0.15, 0.4)):
    g = ShaderGraph()
    t = g.add(sn.CheckerTextureNode(name + "_tex", scale=scale, color1=c1,
                                    color2=c2))
    d = g.add(sn.DiffuseBsdfNode(name + "_bsdf"))
    g.connect(t, "color", d, "color")
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader(name, g)


def image_texture_shader(name, image):
    g = ShaderGraph()
    t = g.add(sn.ImageTextureNode(name + "_tex", image=image))
    d = g.add(sn.DiffuseBsdfNode(name + "_bsdf"))
    g.connect(t, "color", d, "color")
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader(name, g)


def instanced_scene(width=256, height=256, spp=32, grid=4, nlat=12,
                    nlon=24):
    """One sphere geometry instanced grid x grid times over a checkered
    ground plane, a UV image texture on the spheres, a distant sun and a
    constant sky. grid=8 (64 x 528 + 2 flat prims, over the flatten
    limit) keeps the sphere instanced: the big_instanced configuration,
    two-level cluster tables, K5 (or K6). grid=4, the textured_instanced
    configuration, compiles flattened (8,450 static prims built by the
    C++ builder, 385 clusters x 30 triangles: K2 and K3); so does grid=5
    (13,202 prims, 599 clusters x 32: K4 and K3). grid=6 (19,010 flat
    prims) stays instanced with a single-level table of 577 clusters x 38
    triangles with instance rows (K4 and K3), and so does grid=5 with
    nlat=15 (16,802 flat prims; 401 clusters x 48: K2 and K3, K7 in
    fused-NEE mode)."""
    scene = Scene()
    scene.camera.set("matrix", tfm.look_at((14, -18, 10), (0, 0, 1),
                                           (0, 0, 1)))
    scene.camera.set("fov", 0.7)
    scene.camera.set("width", width)
    scene.camera.set("height", height)

    ground = checker_shader("ground")
    scene.add_shader(ground)
    plane = make_plane_mesh((-30, -30, 0), (60, 0, 0), (0, 60, 0), 0,
                            "ground")
    plane.used_shaders = [ground]
    scene.add_object(Object("ground", plane))

    # procedural uv image for the spheres
    img = np.zeros((64, 64, 3), np.float32)
    yy, xx = np.mgrid[0:64, 0:64]
    img[..., 0] = 0.5 + 0.5 * np.sin(xx * 0.4)
    img[..., 1] = 0.5 + 0.5 * np.cos(yy * 0.3)
    img[..., 2] = 0.6
    mat = image_texture_shader("spheremat", img)
    scene.add_shader(mat)

    sphere = make_sphere_mesh((0, 0, 0), 1.0, 0, nlat=nlat, nlon=nlon)
    sphere.set("smooth", np.ones(sphere.num_triangles, bool))
    sphere.used_shaders = [mat]
    for i in range(grid):
        for j in range(grid):
            t = tfm.compose(
                tfm.translate((i - grid / 2 + 0.5) * 4.0,
                              (j - grid / 2 + 0.5) * 4.0, 1.0),
                tfm.rotate(0.3 * (i + j), (0, 0, 1)))
            scene.add_object(Object(f"inst_{i}_{j}", sphere, transform=t))

    scene.add_light(Light("sun", light_type="distant", dir=(-0.3, 0.4, -0.85),
                          strength=(3.0, 2.9, 2.6), angle=0.05))
    scene.background.shader = background_shader("sky", (0.4, 0.6, 0.9), 0.6)
    scene.integrator.set("aa_samples", spp)
    scene.integrator.set("max_bounce", 4)
    return scene
