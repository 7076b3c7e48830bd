"""The dof_motion_adaptive camera in the port against the JAX package:
the lens samples (utils/math.py concentric_sample_disk,
regular_polygon_sample), the motion path (utils/transform.py
motion_interpolate, motion_interpolate_steps), the camera record
(models/camera.py Camera.update) and the rays (ops/camera.py
camera_sample_ray), on inputs made from a seed with numpy.

The record is held array-equal (both compile it in NumPy). The per-lane
functions agree to float32 rounding: the frameworks round sin, cos,
arccos and rsqrt differently, and XLA:CPU contracts products into FMAs.
Tolerances: lens samples atol 1e-6 (points in the unit disk); rotation
and scale entries atol 2e-6; translations and ray origins rtol 1e-6 plus
atol 1e-4 (an ulp of the scene's ~800-unit coordinates is 6e-5); unit
directions atol 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.app import examples as jex
from raytracingproject_tpu.models.camera import Camera as JCamera
from raytracingproject_tpu.ops import camera as jcam
from raytracingproject_tpu.utils import math as jmath
from raytracingproject_tpu.utils import transform as jtfm
from raytracingproject_tpu_torch.app import examples as tex
from raytracingproject_tpu_torch.models.camera import Camera
from raytracingproject_tpu_torch.ops import camera as cam_ops
from raytracingproject_tpu_torch.utils import math as um
from raytracingproject_tpu_torch.utils import transform as tfm

torch.set_num_threads(1)
N = 4096
BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
BASE = tfm.look_at((278, -800, 273), (278, 0, 273), (0, 0, 1))
# camera paths of four steps, and whether motion_interpolate slerps
# between their steps (sin of the quaternions' angle above 1e-5 in
# float32). A translation without rotation has the quaternion (1, 0, 0, 0)
# at every step: the dot product is 1 and every lane takes the nlerp
# branch. The dof configuration's kind, a world translation of the
# Cornell camera, keeps its rotation too, but that quaternion (0.7071,
# 0.7071, 0, 0) has a float32 square norm of 1 - 6e-8, so its steps sit
# 3.45e-4 radians apart and every lane slerps.
PATHS = {
    "translation": [tfm.translate(25.0 * i, 3.0 * i, -2.0 * i)
                    for i in range(4)],
    "dof": [tfm.compose(tfm.translate(25.0 * i, 0.0, 0.0), BASE)
            for i in range(4)],
    "rotation": [tfm.compose(tfm.rotate(a, (0.3, 1.0, 0.2)), BASE)
                 for a in (0.0, 0.5, 1.1, 1.6)],
}
SLERP = {"translation": False, "dof": True, "rotation": True}


def _uniform(seed, rows):
    """(rows, N) float32 samples in [0, 1) with 0 and the largest float32
    below 1 planted in the first lanes."""
    u = np.random.default_rng(seed).uniform(size=(rows, N)).astype(
        np.float32)
    u[:, :4] = [0.0, 0.5, BELOW_ONE, 0.0]
    u[-1, 3] = BELOW_ONE
    return u


def _pair(fn_jax, fn_torch, *arrays):
    got = fn_torch(*(torch.as_tensor(a) for a in arrays))
    ref = fn_jax(*(jnp.asarray(a) for a in arrays))
    return ([np.asarray(r) for r in ref], [g.numpy() for g in got])


@pytest.mark.parametrize("blades", [0, 3, 6])
@pytest.mark.parametrize("rotation", [0.0, 0.7])
def test_lens_samples_match_jax(blades, rotation):
    """blades 0 is the disk the camera falls back to below 3 blades."""
    u1, u2 = _uniform(blades + 10, 2)
    if blades:
        ref, got = _pair(
            lambda a, b: jmath.regular_polygon_sample(float(blades),
                                                      rotation, a, b),
            lambda a, b: um.regular_polygon_sample(float(blades), rotation,
                                                   a, b), u1, u2)
        # the side index stays below the corners at u1 just under 1
        side = torch.floor(torch.tensor(BELOW_ONE) * float(blades))
        assert float(side) == blades - 1
    else:
        ref, got = _pair(jmath.concentric_sample_disk,
                         um.concentric_sample_disk, u1, u2)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, atol=1e-6)
    r2 = got[0] ** 2 + got[1] ** 2
    assert np.isfinite(r2).all() and r2.max() <= 1.0 + 1e-6


def _decomps(path, steps):
    return np.concatenate([tfm.decompose(m) for m in PATHS[path][:steps]])


def _sin_theta(decomps):
    """sin of the angle between each step's quaternion and the next, in
    float32 as motion_interpolate takes it."""
    q = decomps.reshape(-1, 16)[:, :4]
    a, b = q[:-1], q[1:]
    d = np.abs(a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]
               + a[:, 3] * b[:, 3])
    return np.sin(np.arccos(np.clip(d, np.float32(-1.0), np.float32(1.0))))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("steps", [2, 3, 4])
def test_motion_interpolate_steps_matches_jax(path, steps):
    dec = _decomps(path, steps)
    slerp = _sin_theta(dec) > 1e-5
    assert slerp.all() if SLERP[path] else not slerp.any()
    t = _uniform(steps, 1)[0]
    t[3] = 1.0
    ref, got = _pair(
        lambda d, tt: [jtfm.motion_interpolate_steps(d, tt, steps)],
        lambda d, tt: [tfm.motion_interpolate_steps(d, tt, steps)], dec, t)
    ref, got = ref[0], got[0]
    assert got.shape == (N, 3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got[..., :3], ref[..., :3], atol=2e-6)
    np.testing.assert_allclose(got[..., 3], ref[..., 3], rtol=1e-6,
                               atol=1e-4)
    # the path passes through its steps at their shutter times
    ends = tfm.motion_interpolate_steps(
        torch.as_tensor(dec), torch.tensor([0.0, 1.0]), steps).numpy()
    np.testing.assert_allclose(ends[0], PATHS[path][0], atol=1e-4)
    np.testing.assert_allclose(ends[1], PATHS[path][steps - 1], atol=1e-4)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_motion_interpolate_matches_jax(path):
    """Two records at per-lane times, each lane its own pair of records."""
    rng = np.random.default_rng(5)
    steps = np.stack([tfm.decompose(m) for m in PATHS[path]])
    a, b = steps[rng.integers(0, 4, N)], steps[rng.integers(0, 4, N)]
    t = _uniform(7, 1)[0]
    ref, got = _pair(lambda x, y, tt: [jtfm.motion_interpolate(x, y, tt)],
                     lambda x, y, tt: [tfm.motion_interpolate(x, y, tt)],
                     a, b, t)
    np.testing.assert_allclose(got[0][..., :3], ref[0][..., :3], atol=2e-6)
    np.testing.assert_allclose(got[0][..., 3], ref[0][..., 3], rtol=1e-6,
                               atol=1e-4)
    q = torch.as_tensor(a[:, :4])
    np.testing.assert_allclose(tfm.quat_to_matrix(q).numpy(),
                               jtfm.quat_to_matrix(a[:, :4]), atol=1e-6)


def _dof_cameras(pkg_examples, camera_cls):
    """The dof configuration's camera and a three-step set_motion camera
    with a rotating path, a lens and an aperture ratio."""
    dof = pkg_examples.dof_motion_scene(24, 16, spp=4).camera
    steps = camera_cls("steps", width=20, height=30, fov=0.6,
                       aperturesize=5.0, focaldistance=700.0, blades=6,
                       bladesrotation=0.4, aperture_ratio=1.7)
    steps.set_motion(PATHS["rotation"][:3])
    return {"dof": dof, "steps": steps}


@pytest.mark.parametrize("which", ["dof", "steps"])
def test_camera_record_equals_jax(which):
    ref = _dof_cameras(jex, JCamera)[which].update()
    got = _dof_cameras(tex, Camera)[which].update()
    assert set(got) == set(ref)
    for k, v in ref.items():
        v, g = np.asarray(v), np.asarray(got[k])
        assert v.dtype == g.dtype and v.shape == g.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    assert got["use_motion"] == 1
    assert got["motion_steps"] == (2 if which == "dof" else 3)
    assert got["motion_decomps"].shape == (16 * got["motion_steps"],)


def test_set_motion_steps_drop_on_set():
    cam = Camera()
    cam.set_motion(PATHS["rotation"])
    assert len(cam.motion_transforms()) == 4
    cam.set("motion_end", PATHS["rotation"][1])
    assert len(cam.motion_transforms()) == 2
    with pytest.raises(ValueError):
        cam.set_motion(PATHS["rotation"][:1])


# (aperture, blades, bladesrotation, aperture_ratio, motion)
RAY_CASES = {
    "pinhole": (0.0, 0, 0.0, 1.0, None),
    "pinhole_motion": (0.0, 0, 0.0, 1.0, "dof"),
    "disk_ratio": (12.0, 0, 0.0, 1.7, None),
    "disk_motion": (12.0, 0, 0.0, 1.0, "translation"),
    "blades6": (12.0, 6, 0.0, 1.0, None),
    "blades6_dof_config": (12.0, 6, 0.0, 1.0, "dof_config"),
    "blades6_ratio_rotating": (8.0, 6, 0.4, 0.6, "rotation"),
}


def _ray_camera(camera_cls, case):
    aperture, blades, rot, ratio, motion = RAY_CASES[case]
    cam = camera_cls("cam", width=32, height=24, fov=0.686, matrix=BASE,
                     aperturesize=aperture, focaldistance=900.0,
                     blades=blades, bladesrotation=rot,
                     aperture_ratio=ratio)
    if motion == "dof_config":
        cam.set("use_motion", True)
        cam.set("motion_start", BASE)
        cam.set("motion_end", PATHS["dof"][1])
    elif motion is not None:
        cam.set_motion(PATHS[motion][:3])
    return cam.update()


@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_camera_sample_ray_matches_jax(case):
    u = np.random.default_rng(len(case)).uniform(size=(5, N)).astype(
        np.float32)
    rx, ry = u[0] * 32.0, u[1] * 24.0
    ref = jcam.camera_sample_ray(_ray_camera(JCamera, case),
                                 *(jnp.asarray(a) for a in (rx, ry, *u[2:])))
    got = cam_ops.camera_sample_ray(_ray_camera(Camera, case),
                                    *(torch.as_tensor(a)
                                      for a in (rx, ry, *u[2:])))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["o"], ref["o"], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["d"], ref["d"], atol=1e-6)
    for k in ("tmin", "tmax", "time"):
        np.testing.assert_array_equal(got[k], ref[k])
    # the lens spreads the origins over the aperture; a pinhole camera
    # that does not move has one origin
    spread = np.ptp(got["o"], axis=0).max()
    aperture, _b, _r, _ratio, motion = RAY_CASES[case]
    assert (spread > 1.0) == (aperture > 0.0 or motion is not None)


def test_translating_camera_keeps_its_rotation():
    """The dof configuration's camera only translates: at every shutter
    time its rays point as those of the camera held at its start, bit for
    bit, and leave from the start's origins moved along the path (to an
    ulp of the ~800-unit coordinates). The camera-to-world is interpolated
    in float64 and rounded once; interpolated in float32, the slerp and
    the normalised quaternion leave rotation entries 6e-8 or 1.2e-7 off,
    which turn the rays by as much and flip camera rays that graze a
    sphere."""
    moving = _ray_camera(Camera, "blades6_dof_config")
    held = dict(moving, use_motion=np.int32(0),
                cam_to_world=np.asarray(BASE, np.float32))
    u = np.random.default_rng(11).uniform(size=(5, N)).astype(np.float32)
    args = [torch.as_tensor(a) for a in (u[0] * 32.0, u[1] * 24.0, *u[2:])]
    got = cam_ops.camera_sample_ray(moving, *args)
    ref = cam_ops.camera_sample_ray(held, *args)
    assert torch.equal(got["d"], ref["d"])
    shift = args[4][:, None] * torch.tensor([25.0, 0.0, 0.0])
    np.testing.assert_allclose(got["o"].numpy(), (ref["o"] + shift).numpy(),
                               rtol=0.0, atol=1e-4)


@pytest.mark.parametrize("setting", ["orthographic", "panorama", "rolling"])
def test_unported_cameras_raise(setting):
    cam = Camera("cam", width=8, height=8)
    if setting == "rolling":
        cam.set("rolling_shutter_type", "top")
        rec = cam.update()
        z = torch.zeros(4)
        with pytest.raises(NotImplementedError):
            cam_ops.camera_sample_ray(rec, z, z, z, z, z)
    else:
        cam.set("type", setting)
        with pytest.raises(NotImplementedError):
            cam.update()
