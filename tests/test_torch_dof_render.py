"""The dof_motion_adaptive slice as a whole, on the CPU (K2's and K3's
plain versions):

- the port's host compile of dof_motion_scene against the JAX package's:
  array-equal tables, filter table and camera record, equal statics; the
  scene is the glossy Cornell box, so only the camera differs from it;
- the port's render_samples_regen at 16x16, 8 spp, clamp off, against the
  JAX package's (through its Session, adaptive sampling off), under
  tests/test_torch_render.py's criteria (>= 99% of the pixels within
  1e-3, the mean within 0.5%): lens and motion camera rays, then the
  glossy box's walks;
- `render` takes the session's adaptive branch for this scene, because it
  declares adaptive sampling, and its real 16x16 render through that
  branch agrees with the JAX package's Session in its image mean (1%);
  tests/test_torch_adaptive_host.py holds the branch exactly under a
  synthetic renderer and the host driver render_adaptive on the real
  render;

- a shadow ray that grazes the lamp's plane is not blocked by the lamp
  triangle it samples: the pixel of one such sample, whose float32
  shadow test the JAX package itself blocks or passes depending on the
  wavefront's shape, agrees with the JAX package's float64 render of it
  (ops/integrator.py _light_plane_tmax).

`jax_mean` is also how chip_smoke.py's JAX_MEAN_DOF_256 was made, once,
on the CPU (about 3 minutes):

    python -m tests.test_torch_dof_render mean 256 64 32

prints the image mean of the JAX package's own 256x256, 64-spp render of
dof_motion_scene() in chunks of 32 with the default clamp;

    python -m tests.test_torch_dof_render twin \
        raytracingproject_tpu_torch/data/twin_dof_motion.npz

makes the reference of chip_smoke.py's dof accuracy phase and of the
grazing test below (about 3 minutes): the JAX package's render of the
64x64x128 scene with the clamp off in float64 throughout (see jax_twin);
and

    python -m tests.test_torch_dof_render pixel f32|f64 10 39

prints one pixel of the JAX package's fixed 64x64x128 render of that
scene as tools/rmse_twin.py renders its twins (render_samples_regen,
chunks of 16, the camera's motion record in float32) twice: with the
pixel alone in the wavefront and with its row of 64 pixels. At pixel
(10, 39) the two differ, under set_f64 too: motion_interpolate computes
in the record's dtype, so the camera-to-world rounds by a float32 ulp or
two, differently under each compilation of the loop, and one camera ray
of the pixel that grazes a glossy sphere turns with it."""

import functools
import os
import sys

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "twin" or (sys.argv[1] == "pixel"
                                 and sys.argv[2] == "f64"):
        from raytracingproject_tpu.utils import precision
        precision.set_f64()

import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.ops import integrator as jinteg
from raytracingproject_tpu.session.session import (
    Session as JSession, SessionParams)
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models.scene import (
    KG_ARRAYS, kg_from_jax)
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.ops import intersect as isect
from raytracingproject_tpu_torch.session.session import (
    pixel_wavefront, render)

torch.set_num_threads(1)
W = H = 16
SPP, CHUNK = 8, 4
# (row, column, sample) of the 64x64 render: a ceiling point beside the
# lamp, its shadow ray 0.006 under the lamp's plane at a slope of 9e-4
GRAZING = (56, 26, 77)
# the JAX package's render of the 64x64 scene in float64 throughout
# (python -m tests.test_torch_dof_render twin TWIN)
TWIN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "raytracingproject_tpu_torch", "data",
    "twin_dof_motion.npz")


def _scene(ex):
    s = ex.dof_motion_scene(W, H, spp=SPP)
    s.integrator.set("sample_clamp_indirect", 0.0)
    s.device_update()
    return s


@functools.lru_cache(maxsize=None)
def _jax_scene():
    return _scene(jex)


def _jax_kg():
    return _jax_scene().make_kernel_globals(device_put=False)


@functools.lru_cache(maxsize=None)
def _port_scene():
    return _scene(tex)


@pytest.fixture(scope="module")
def pair():
    return _jax_kg(), _port_scene().make_kernel_globals("cpu")


@pytest.mark.parametrize("name", KG_ARRAYS)
def test_scene_arrays_equal(pair, name):
    jkg, tkg = pair
    ref = np.asarray(jkg["dscene"][name])
    got = tkg["dscene"][name].numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def test_statics_and_camera_equal(pair):
    jkg, tkg = pair
    np.testing.assert_array_equal(np.asarray(jkg["filter_table"]),
                                  tkg["filter_table"].numpy())
    assert set(jkg["cam"]) == set(tkg["cam"])
    for k, v in jkg["cam"].items():
        got = np.asarray(tkg["cam"][k])
        assert np.asarray(v).dtype == got.dtype, k
        np.testing.assert_array_equal(np.asarray(v), got, err_msg=k)
    assert jkg["kint"] == tkg["kint"]
    for k in ("cluster_tris", "use_brute", "light_kinds", "has_instances"):
        assert jkg[k] == tkg[k], k
    # the glossy box's tables, walked without time: K2 and K3 as on glossy
    assert not jkg["has_motion"] and not jkg["cluster_motion"]
    assert tkg["use_brute"] is False and tkg["cluster_tris"] == 15
    assert tkg["dscene"]["cluster_table"].shape[0] == 179
    assert int(tkg["cam"]["use_motion"]) == 1
    assert int(tkg["cam"]["motion_steps"]) == 2
    assert float(tkg["cam"]["aperturesize"]) == 12.0
    assert int(tkg["cam"]["blades"]) == 6


def _port_image(kg):
    """The 16x16 fixed render (render_samples_regen, one chunk)."""
    px, py, pidx = pixel_wavefront(W, H, 1, "cpu")
    L, A = integ.render_samples_regen(kg, px, py, pidx, 0, SPP)
    assert torch.equal(A, torch.full_like(A, float(SPP)))
    return (L / SPP).numpy().reshape(H, W, 3)


@functools.lru_cache(maxsize=None)
def _jax_session_images():
    """One JAX Session over the scene: first with adaptive sampling off
    (every pixel SPP samples of render_samples_regen in chunks of CHUNK),
    then, through render_range on the same compiled function, with the
    scene's adaptive sampling on. Returns (fixed image, adaptive image,
    adaptive per-pixel counts)."""
    s = _scene(jex)
    threshold = float(s.integrator.adaptive_threshold)
    s.integrator.set("adaptive_threshold", 0.0)
    sess = JSession(s, SessionParams(samples=SPP,
                                     progressive_refine_chunk=CHUNK))
    fixed = sess.render()[..., :3].astype(np.float32)
    s.integrator.set("adaptive_threshold", threshold)
    adaptive = sess.render_range(0, SPP)[..., :3].astype(np.float32)
    return fixed, adaptive, sess.buffers.per_pixel_samples


def _assert_images_agree(got, ref):
    d = np.abs(got - ref).max(-1)
    assert (d <= 1e-3).mean() >= 0.99, (d > 1e-3).sum()
    assert abs(got.mean() / ref.mean() - 1.0) <= 5e-3
    assert np.isfinite(got).all() and got.mean() > 0.05


@pytest.fixture(scope="module")
def port_image(pair):
    return _port_image(pair[1])


def test_render_matches_jax(port_image):
    _assert_images_agree(port_image, _jax_session_images()[0])


def test_kg_from_jax_keeps_the_camera(pair):
    """kg_from_jax carries the lens and motion record over: the JAX
    package's compile converts to the port's own, record for record and
    table for table, so it renders bit for bit alike."""
    jkg, tkg = pair
    got = kg_from_jax(jkg, "cpu")
    for k, v in tkg["cam"].items():
        np.testing.assert_array_equal(np.asarray(got["cam"][k]),
                                      np.asarray(v), err_msg=k)
    for k, v in tkg["dscene"].items():
        assert torch.equal(got["dscene"][k], v), k
    np.testing.assert_array_equal(got["filter_table"].numpy(),
                                  tkg["filter_table"].numpy())


def test_session_adaptive_branch_mean_agrees_with_jax(pair):
    """The real render through render's adaptive branch and through the
    JAX package's Session: the image means agree within 1% (the two
    frameworks round the same samples differently, which can move a
    pixel across the threshold), and so do the samples rendered (5%)."""
    st = {}
    img = render(_port_scene(), SPP, chunk=CHUNK, device="cpu", kg=pair[1],
                 stats=st)
    _fixed, ref, counts = _jax_session_images()
    assert st["adaptive"] and np.isfinite(img).all()
    assert abs(st["samples_rendered"] / counts.sum() - 1.0) <= 0.05
    assert abs(img.mean() / ref.mean() - 1.0) <= 0.01


def test_render_takes_the_adaptive_branch():
    s = tex.dof_motion_scene(8, 8, spp=4)
    st = {}
    img = render(s, 4, chunk=2, device="cpu", stats=st)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert st["adaptive"] and st["samples_nominal"] == 8 * 8 * 4
    assert 0 < st["samples_rendered"] <= st["samples_nominal"]


def _grazing_scene(ex):
    s = ex.dof_motion_scene(64, 64, spp=128)
    s.integrator.set("sample_clamp_indirect", 0.0)
    s.device_update()
    return s


def test_grazing_shadow_ray_keeps_its_light():
    """Pixel (56, 26) of the 64x64 render, its 128 samples one lane each,
    against the JAX package's float64 render of it (TWIN). One of the
    samples (GRAZING) is the grazing shadow ray: without the pulled-back
    segment it goes dark and the pixel is 2.2e-3 off in red. The
    reference is the committed twin and not a render made here: the
    float64 render needs jax_enable_x64, which holds for a whole process,
    so it takes a process of its own and about 20 s, a third of these
    files' budget (TWIN names the command that made it)."""
    y, x, _sample = GRAZING
    kg = _grazing_scene(tex).make_kernel_globals("cpu")
    n = 128
    lane = [torch.full((n,), v) for v in (x, y, y * 64 + x)]
    L, _A, _E = integ.render_samples_adaptive_chunk(
        kg, *lane, torch.arange(n), 1)
    ref = np.load(TWIN)["dof_motion_adaptive"][y, x]
    np.testing.assert_allclose(L.double().sum(0).numpy() / n, ref, atol=1e-4)


def test_self_hit_shortens_only_a_grazing_segment():
    """That sample's shadow ray meets the lamp triangle it samples inside
    its segment (the watertight test finds it there); the segment now
    ends short of that point. A steep ray that meets the triangle only at
    the sampled point keeps its segment."""
    tri = torch.tensor([[213.0, 227.0, 548.7], [343.0, 227.0, 548.7],
                        [343.0, 332.0, 548.7]])
    # the sample's shadow ray and segment end, as the render forms them;
    # and a steep ray from the floor to a point of the same triangle
    o = torch.tensor([[220.08124, 224.24622, 548.69385],
                      [278.0, 280.0, 100.0]])
    d = torch.tensor([[-0.8971991, 0.44162524, 0.000934226],
                      [0.3, -0.2, 4.487]])
    d[1] = d[1] / torch.linalg.vector_norm(d[1])
    dist = torch.tensor([(6.591867 + integ.RAY_EPS) / (1.0 - 1e-3),
                         (548.7 - 100.0) / float(d[1, 2])])
    tmax = dist * (1.0 - 1e-3) - integ.RAY_EPS
    ls = {"Ng_l": torch.tensor([[0.0, 0.0, -1.0]]).expand(2, 3),
          "P_l": o + d * dist[:, None],
          "is_tri": torch.tensor([True, True])}
    got = integ._light_plane_tmax(ls, o, d, dist, tmax)
    ws = isect.watertight_setup(o, d)
    corners = [tuple(c.expand(2, 3)[:, j] for j in range(3)) for c in tri]
    hit, t, _u, _v = isect.watertight_test(ws, *corners, 1e-5, tmax)
    assert bool(hit[0]) and not bool(hit[1])
    assert got[1] == tmax[1]
    assert got[0] < t[0] * (1.0 - 5e-3)
    hit, _t, _u, _v = isect.watertight_test(ws, *corners, 1e-5, got)
    assert not bool(hit.any())


def jax_mean(width, spp, chunk, rows=64):
    """Image mean of the JAX package's dof_motion_adaptive render at width
    x width x spp, chunks of `chunk` samples, accumulated in float64; the
    film goes through in strips of `rows` rows (a lane's samples depend
    on its pixel alone)."""
    js = jex.dof_motion_scene(width, width, spp=spp)
    js.device_update()
    kg = js.make_kernel_globals()
    fn = jax.jit(lambda a, b, c, s: jinteg.render_samples_regen(
        kg, a, b, c, s, chunk))
    total = 0.0
    for y0 in range(0, width, rows):
        yy, xx = np.mgrid[y0:min(y0 + rows, width), 0:width]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        for i in range(spp // chunk):
            L, _A = fn(px, py, py * width + px, jnp.uint32(i * chunk))
            total += float(np.asarray(L, np.float64).sum())
    return total / (width * width * 3 * spp)


def jax_pixel(y, x, spp=128, chunk=16):
    """Pixel (y, x) of the JAX package's fixed render of the 64x64 grazing
    scene, with the pixel alone in the wavefront and with its row."""
    kg = _grazing_scene(jex).make_kernel_globals()
    fn = jax.jit(lambda a, b, c, s: jinteg.render_samples_regen(
        kg, a, b, c, s, chunk))
    out = []
    for xs in (np.array([x]), np.arange(64)):
        px = jnp.asarray(xs, jnp.int32)
        py = jnp.full(xs.shape, y, jnp.int32)
        acc = sum(np.asarray(fn(px, py, py * 64 + px, jnp.uint32(s))[0],
                             np.float64) for s in range(0, spp, chunk))
        out.append(tuple(float(v) for v in acc[list(xs).index(x)] / spp))
    return out


def jax_twin(path, spp=128, chunk=16):
    """The JAX package's float64 render of the 64x64 grazing scene with
    the clamp off, float64 throughout: utils/precision.py set_f64 (as
    tools/rmse_twin.py renders its twins) and the camera's motion record
    cast to float64, since motion_interpolate computes in the record's
    dtype (float32 in tools/rmse_twin.py's twins, whose camera-to-world
    thus rounds by a few float32 ulps, differently under each
    compilation). Rendered twice, through render_samples_regen over the
    whole frame in chunks of `chunk` samples and through render_samples
    a row of 64 pixels at a time; the two must agree to 1e-9. The first
    is saved in `path` under "dof_motion_adaptive"."""
    kg = _grazing_scene(jex).make_kernel_globals()
    kg["cam"] = dict(kg["cam"], motion_decomps=np.asarray(
        kg["cam"]["motion_decomps"], np.float64))

    def frame(render, rows):
        fn = jax.jit(lambda a, b, c, s: render(kg, a, b, c, s, chunk))
        img = np.zeros((64, 64, 3))
        for y0 in range(0, 64, rows):
            yy, xx = np.mgrid[y0:y0 + rows, 0:64]
            px = jnp.asarray(xx.reshape(-1), jnp.int32)
            py = jnp.asarray(yy.reshape(-1), jnp.int32)
            acc = sum(np.asarray(fn(px, py, py * 64 + px, jnp.uint32(s))[0],
                                 np.float64) for s in range(0, spp, chunk))
            img[y0:y0 + rows] = acc.reshape(rows, 64, 3) / spp
        return img

    whole = frame(jinteg.render_samples_regen, 64)
    by_row = frame(jinteg.render_samples, 1)
    diff = float(np.abs(whole - by_row).max())
    assert diff <= 1e-9, diff
    np.savez_compressed(path, dof_motion_adaptive=whole)
    return diff


if __name__ == "__main__":
    if sys.argv[1] == "twin":
        print("twin", sys.argv[2], "wavefronts differ by at most",
              jax_twin(sys.argv[2]))
    elif sys.argv[1] == "pixel":
        alone, row = jax_pixel(*(int(v) for v in sys.argv[3:5]))
        print("pixel", sys.argv[2], "alone", repr(alone), "in its row",
              repr(row))
    else:
        width, spp, chunk = (int(x) for x in sys.argv[2:5])
        print("mean", width, spp, chunk, repr(jax_mean(width, spp, chunk)))
