"""The big_instanced configuration's host compile and its new shading
modules, port against the JAX package:

- the port's compile of instanced_scene(grid=8) is array-equal to the JAX
  package's make_kernel_globals on every array the port reads (the prim,
  object and cluster tables, sc_bounds, the lamp table, the light
  distribution and entry rows, the volume-boundary tables) and equal in
  the statics (sc_gmax, cluster_tris, has_instances, use_brute, the light
  kinds and lamp types, the background slot, the features, the texture
  store and the camera pixel angle); kg_from_jax converts losslessly;
- CheckerTextureNode (box-filtered over the footprint, and point-sampled),
  ImageTextureNode and sample_image (every interpolation and extension)
  and the general sample_light with a distant lamp (alone, and mixed with
  emissive triangles) against their JAX counterparts on seeded inputs.

Tolerances: the tables and statics are exact. The texture and light
values are held to 1e-6 (absolute on [0, 1] colours, relative on pdfs):
the two frameworks round sin, cos and sqrt each in their own way, an ulp
or two apart. The box-filtered checker divides a difference of two
triangle waves at p +- w / 2 by the footprint width w; XLA:CPU contracts
p + 0.5 * w into one multiply-add, so where w is narrow the JAX value
moves by ulp(p) / w: there (2 lanes in 4,096) the two agree to 2e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.models import image as jimage
from raytracingproject_tpu.models import light as jlight
from raytracingproject_tpu.models import shader_nodes as jsn
from raytracingproject_tpu.ops import light as jlight_ops
from raytracingproject_tpu.ops import shade as jshade
from raytracingproject_tpu.ops import texture as jtex
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models import light as tlight
from raytracingproject_tpu_torch.models import shader_nodes as tsn
from raytracingproject_tpu_torch.models.image import TextureStore
from raytracingproject_tpu_torch.models.scene import (
    KG_ARRAYS, KG_OPTIONAL, kg_from_jax)
from raytracingproject_tpu_torch.ops import light as tlight_ops
from raytracingproject_tpu_torch.ops import shade as tshade
from raytracingproject_tpu_torch.ops import texture as ttex

torch.set_num_threads(1)
W = 64
STATICS = ("sc_gmax", "cluster_tris", "has_instances", "use_brute",
           "light_kinds", "lamp_types", "num_area_lamps",
           "background_shader", "volume_stack_depth")


@pytest.fixture(scope="module")
def pair():
    js = jex.instanced_scene(W, W, spp=2, grid=8)
    js.device_update()
    jkg = js.make_kernel_globals(device_put=False)
    ts = tex.instanced_scene(W, W, spp=2, grid=8)
    ts.device_update()
    return jkg, ts.make_kernel_globals("cpu")


@pytest.mark.parametrize("name", KG_ARRAYS + KG_OPTIONAL)
def test_scene_arrays_equal(pair, name):
    jkg, tkg = pair
    ref = np.asarray(jkg["dscene"][name])
    got = tkg["dscene"][name].numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def test_table_sizes(pair):
    """64 x 528 + 2 flat prims stay instanced: 530 packed prims, 65
    objects, 1,025 clusters x 38 triangles in 65 groups (1 ground cluster,
    16 per sphere), one distant lamp and no emissive triangle."""
    _jkg, tkg = pair
    ds = tkg["dscene"]
    assert ds["prim_table"].shape == (530, 36)
    assert ds["object_table"].shape[0] == 65
    assert ds["cluster_table"].shape == (1025, 13 + 38 * 12)
    assert ds["sc_bounds"].shape == (65, 8)
    assert tkg["sc_gmax"] == 64 and tkg["cluster_tris"] == 38
    assert tkg["has_instances"] and tkg["use_brute"] is False
    assert tkg["light_kinds"] == (tlight.LIGHT_DISTANT,)
    assert float(ds["bg_pmf"]) == 0.0


def test_statics_equal(pair):
    jkg, tkg = pair
    assert jkg["kint"] == tkg["kint"]
    for k in STATICS:
        assert jkg[k] == tkg[k], k
    assert [s.name for s in jkg["shaders"]] == [s.name for s in tkg["shaders"]]
    on = {k for k, v in jkg["features"].items() if v is True}
    assert on == {k for k, v in tkg["features"].items() if v}
    jt, tt = jkg["textures"], tkg["textures"]
    np.testing.assert_array_equal(np.asarray(jt.data), tt.data.numpy())
    assert [tuple(s) for s in jt.sizes] == tt.sizes
    assert jt.pixel_angle == tt.pixel_angle == 0.7 / W


def test_kg_from_jax_round_trip(pair):
    jkg, tkg = pair
    ckg = kg_from_jax(jkg, "cpu")
    assert set(ckg["dscene"]) == set(tkg["dscene"])
    for k in ckg["dscene"]:
        assert torch.equal(ckg["dscene"][k], tkg["dscene"][k]), k
    for k in STATICS + ("features",):
        assert ckg[k] == tkg[k], k
    assert torch.equal(ckg["textures"].data, tkg["textures"].data)
    img = [n for s in ckg["shaders"] for n in s.graph.nodes
           if isinstance(n, tsn.ImageTextureNode)]
    assert len(img) == 1 and img[0].slot == 0


# ---- texture nodes ----------------------------------------------------

N = 4096


def _ctx_pair(footprint):
    """Seeded shading contexts for both packages: generated coordinates
    and uvs over a few periods, ray lengths, and a per-lane
    world -> generated map (None: point sampling)."""
    r = np.random.default_rng(5)
    gen = r.uniform(-1.5, 2.5, (N, 3)).astype(np.float32)
    uv = r.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    rl = r.uniform(0.1, 60.0, N).astype(np.float32)
    gt = r.uniform(-0.2, 0.2, (N, 3, 4)).astype(np.float32) \
        if footprint else None
    img = r.uniform(0, 1, (1, 24, 40, 4)).astype(np.float32)
    jstore = jimage.TextureStore(jnp.asarray(img), [(24, 40)])
    jstore.pixel_angle = 0.7 / 256 if footprint else None
    tstore = TextureStore.from_numpy(img, [(24, 40)], "cpu",
                                     pixel_angle=jstore.pixel_angle)
    jctx = jshade.ShaderData(
        generated=jnp.asarray(gen), uv=jnp.asarray(uv),
        ray_length=jnp.asarray(rl),
        gen_tfm=None if gt is None else jnp.asarray(gt), textures=jstore,
        batch_shape=(N,))
    tctx = tshade.ShaderData(
        generated=torch.tensor(gen), uv=torch.tensor(uv),
        ray_length=torch.tensor(rl),
        gen_tfm=None if gt is None else torch.tensor(gt), textures=tstore,
        batch_shape=(N,), device=torch.device("cpu"))
    return jctx, tctx


@pytest.mark.parametrize("footprint", [True, False],
                         ids=["box_filtered", "point_sampled"])
def test_checker_matches_jax(footprint):
    jctx, tctx = _ctx_pair(footprint)
    kw = dict(scale=4.0, color1=(0.8, 0.8, 0.8), color2=(0.15, 0.15, 0.4))
    jn, tn = jsn.CheckerTextureNode("c", **kw), tsn.CheckerTextureNode("c",
                                                                       **kw)
    inp = {"vector": np.zeros(3, np.float32),
           "color1": np.asarray(kw["color1"], np.float32),
           "color2": np.asarray(kw["color2"], np.float32), "scale": 4.0}
    ref = jn.eval(jctx, inp)
    got = tsn.eval_node(tn, tctx, inp)
    fac = got["fac"].numpy()
    if footprint:   # filtered values lie strictly between the colours
        assert ((fac > 0.01) & (fac < 0.99)).mean() > 0.05
    else:
        assert set(np.unique(fac)) == {0.0, 1.0}
    err = np.abs(fac - np.asarray(ref["fac"]))
    assert (err > 1e-6).mean() <= 1e-3 and err.max() <= 2e-5
    np.testing.assert_allclose(got["color"].numpy(),
                               np.asarray(ref["color"]), rtol=0, atol=2e-5)


def test_image_texture_node_matches_jax():
    jctx, tctx = _ctx_pair(False)
    jn, tn = jsn.ImageTextureNode("i"), tsn.ImageTextureNode("i")
    jn.slot = tn.slot = 0
    inp = {"vector": np.zeros(3, np.float32)}
    ref, got = jn.eval(jctx, inp), tsn.eval_node(tn, tctx, inp)
    for k in ("color", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6)
    tn.use_auto_mip = True
    with pytest.raises(NotImplementedError):
        tsn.eval_node(tn, tctx, inp)


@pytest.mark.parametrize("interp", [ttex.INTERPOLATION_CLOSEST,
                                    ttex.INTERPOLATION_LINEAR])
@pytest.mark.parametrize("ext", [ttex.EXTENSION_REPEAT, ttex.EXTENSION_EXTEND,
                                 ttex.EXTENSION_CLIP])
def test_sample_image_matches_jax(interp, ext):
    jctx, tctx = _ctx_pair(False)
    data, h, w = tctx.textures.get(0)
    u, v = tctx.uv[:, 0], tctx.uv[:, 1]
    got = ttex.sample_image(data, h, w, u, v, interp, ext).numpy()
    jd, jh, jw = jctx.textures.get(0)
    ref = np.asarray(jtex.sample_image(jd, jh, jw, jctx.uv[:, 0],
                                       jctx.uv[:, 1], interp, ext))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---- lights -----------------------------------------------------------

def _sun(strength=(3.0, 2.9, 2.6)):
    return dict(light_type="distant", dir=(-0.3, 0.4, -0.85),
                strength=strength, angle=0.05)


@pytest.fixture(scope="module")
def mixed_pair():
    """The glossy Cornell box (two emissive triangles) with a sun added,
    bright enough to take about a fifth of the picks: a distribution of
    triangles and a distant lamp."""
    sun = _sun((2e5, 2e5, 2e5))
    js = jex.cornell_box(16, 16, spp=2, spheres="glossy")
    js.add_light(jlight.Light("sun", **sun))
    js.device_update()
    ts = tex.cornell_box(16, 16, spp=2, spheres="glossy")
    ts.add_light(tlight.Light("sun", **sun))
    ts.device_update()
    return js.make_kernel_globals(device_put=False), \
        ts.make_kernel_globals("cpu")


@pytest.mark.parametrize("scene", ["big_instanced", "tri_and_distant"])
def test_sample_light_matches_jax(pair, mixed_pair, scene):
    jkg, tkg = pair if scene == "big_instanced" else mixed_pair
    kinds = tkg["light_kinds"]
    assert kinds == jkg["light_kinds"]
    for k in KG_ARRAYS:
        np.testing.assert_array_equal(np.asarray(jkg["dscene"][k]),
                                      tkg["dscene"][k].numpy(), err_msg=k)
    r = np.random.default_rng(9)
    P = r.uniform(-20, 400, (N, 3)).astype(np.float32)
    us = r.uniform(size=(3, N)).astype(np.float32)
    ref = jlight_ops.sample_light(
        {k: jnp.asarray(v) for k, v in jkg["dscene"].items()},
        jnp.asarray(P), *(jnp.asarray(u) for u in us), static_kinds=kinds)
    got = tlight_ops.sample_light(tkg["dscene"], torch.tensor(P),
                                  *(torch.tensor(u) for u in us),
                                  static_kinds=kinds)
    for k in ("valid", "delta", "is_bg"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("D", "dist", "pdf", "eval", "Ng_l", "pmf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    distant = got["dist"].numpy() >= 1e29
    if scene == "big_instanced":
        assert distant.all() and got["valid"].numpy().all()
    else:
        assert 0.0 < distant.mean() < 1.0


def test_unported_lamps_raise(pair):
    _jkg, tkg = pair
    P = torch.zeros((4, 3))
    u = torch.full((4,), 0.5)
    for kind in (tlight.LIGHT_POINT, tlight.LIGHT_AREA, tlight.LIGHT_SPOT):
        with pytest.raises(NotImplementedError):
            tlight_ops.sample_light(tkg["dscene"], P, u, u, u,
                                    static_kinds=(kind,))
    s = tex.instanced_scene(8, 8, grid=8)
    s.add_light(tlight.Light("env", light_type="background"))
    with pytest.raises(NotImplementedError):
        s.device_update()
