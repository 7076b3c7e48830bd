"""Camera node (JAX counterpart: raytracingproject_tpu/models/camera.py).

`update()` builds the same flattened record as the JAX package (every
key, same dtypes and values) for the perspective camera, with its lens
(aperture, blades, focal distance) and its motion path (two or more
camera-to-world transforms at uniform shutter times, decomposed for the
per-lane interpolation of ops/camera.py). The record still carries the
panorama fields so kernel globals compare key for key. Orthographic and
panorama cameras raise here, rolling shutter in ops/camera.py.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.models.node import Node, SocketType as S
from raytracingproject_tpu_torch.utils import transform as tfm

CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1
CAMERA_PANORAMA = 2


class Camera(Node):
    SOCKETS = [
        S("type", S.ENUM, "perspective",
          {"perspective": CAMERA_PERSPECTIVE,
           "orthographic": CAMERA_ORTHOGRAPHIC,
           "panorama": CAMERA_PANORAMA}),
        S("panorama_type", S.ENUM, "equirectangular",
          {"equirectangular": 0, "fisheye_equidistant": 1,
           "fisheye_equisolid": 2, "mirrorball": 3}),
        S("matrix", S.TRANSFORM, tfm.identity()),
        S("fov", S.FLOAT, 0.7853981852531433),
        S("aperturesize", S.FLOAT, 0.0),
        S("focaldistance", S.FLOAT, 10.0),
        S("blades", S.UINT, 0),
        S("bladesrotation", S.FLOAT, 0.0),
        S("aperture_ratio", S.FLOAT, 1.0),
        S("fisheye_fov", S.FLOAT, 3.14159265),
        S("fisheye_lens", S.FLOAT, 10.5),
        S("latitude_min", S.FLOAT, -1.5707963),
        S("latitude_max", S.FLOAT, 1.5707963),
        S("longitude_min", S.FLOAT, -3.14159265),
        S("longitude_max", S.FLOAT, 3.14159265),
        S("nearclip", S.FLOAT, 1e-5),
        S("farclip", S.FLOAT, 1e5),
        S("viewplane_left", S.FLOAT, 0.0),
        S("viewplane_right", S.FLOAT, 0.0),
        S("viewplane_bottom", S.FLOAT, 0.0),
        S("viewplane_top", S.FLOAT, 0.0),
        S("shuttertime", S.FLOAT, 1.0),
        S("rolling_shutter_type", S.ENUM, "none", {"none": 0, "top": 1}),
        S("rolling_shutter_duration", S.FLOAT, 0.1),
        S("use_motion", S.BOOLEAN, False),
        S("motion_start", S.TRANSFORM, tfm.identity()),
        S("motion_end", S.TRANSFORM, tfm.identity()),
        S("width", S.INT, 1024),
        S("height", S.INT, 512),
    ]

    def __init__(self, name="camera", **kwargs):
        super().__init__(name, **kwargs)
        self._motion_steps = None  # the full step list of set_motion

    def set_motion(self, tfms):
        """Multi-step camera motion: a list of 3x4 camera-to-world
        transforms at uniform shutter times."""
        tfms = [np.asarray(t, np.float32) for t in tfms]
        if len(tfms) < 2:
            raise ValueError("camera motion needs at least two transforms")
        self.set("use_motion", True)
        self.set("motion_start", tfms[0])
        self.set("motion_end", tfms[-1])
        self._motion_steps = tfms  # after set(), which drops the list

    def set(self, name, value):
        if name in ("motion_start", "motion_end") \
                and getattr(self, "_motion_steps", None) is not None:
            self._motion_steps = None
        super().set(name, value)

    def motion_transforms(self):
        if self._motion_steps is not None:
            return self._motion_steps
        return [np.asarray(self.motion_start, np.float32),
                np.asarray(self.motion_end, np.float32)]

    def compute_auto_viewplane(self):
        """Aspect-correct screen window."""
        w, h = float(self.width), float(self.height)
        aspect = w / h
        if w >= h:
            return -aspect, aspect, -1.0, 1.0
        return -1.0, 1.0, -1.0 / aspect, 1.0 / aspect

    def update(self):
        """Precompute raster->camera and camera->world."""
        ctype = self.get_enum_int("type")
        if ctype != CAMERA_PERSPECTIVE:
            raise NotImplementedError("only the perspective camera is ported")
        w, h = float(self.width), float(self.height)
        left, right, bottom, top = (self.viewplane_left, self.viewplane_right,
                                    self.viewplane_bottom, self.viewplane_top)
        if left == right or bottom == top:
            left, right, bottom, top = self.compute_auto_viewplane()
        screen_to_ndc = np.array([
            [1.0 / (right - left), 0, 0, -left / (right - left)],
            [0, 1.0 / (top - bottom), 0, -bottom / (top - bottom)],
            [0, 0, 1, 0]], np.float32)
        ndc_to_raster = np.array([
            [w, 0, 0, 0],
            [0, h, 0, 0],
            [0, 0, 1, 0]], np.float32)
        raster_to_screen = tfm.inverse(tfm.compose(ndc_to_raster,
                                                   screen_to_ndc))
        zoom = 1.0 / np.tan(0.5 * self.fov)
        screen_scale = np.array([
            [1.0 / zoom, 0, 0, 0],
            [0, 1.0 / zoom, 0, 0],
            [0, 0, 1, 0]], np.float32)
        raster_to_camera = tfm.compose(screen_scale, raster_to_screen)
        cam_to_world = np.asarray(self.matrix, np.float32)
        path = (self.motion_transforms() if self.use_motion
                else [cam_to_world] * 2)
        return {
            "type": np.int32(ctype),
            "panorama_type": np.int32(self.get_enum_int("panorama_type")),
            "raster_to_camera": raster_to_camera,
            "cam_to_world": cam_to_world,
            "nearclip": np.float32(self.nearclip),
            "cliplength": np.float32(
                self.farclip - self.nearclip if self.farclip < 1e9 else -1.0),
            "aperturesize": np.float32(self.aperturesize),
            "focaldistance": np.float32(
                self.focaldistance if self.focaldistance > 1e-5 else 1e-5),
            "blades": np.int32(self.blades),
            "bladesrotation": np.float32(self.bladesrotation),
            "aperture_ratio": np.float32(self.aperture_ratio),
            "fisheye_fov": np.float32(self.fisheye_fov),
            "fisheye_lens": np.float32(self.fisheye_lens),
            "eq_bounds": np.array([self.longitude_min, self.longitude_max,
                                   self.latitude_min, self.latitude_max],
                                  np.float32),
            "shuttertime": np.float32(self.shuttertime),
            "rolling_shutter_type": np.int32(
                self.get_enum_int("rolling_shutter_type")),
            "rolling_shutter_duration": np.float32(
                self.rolling_shutter_duration),
            "use_motion": np.int32(1 if self.use_motion else 0),
            "motion_start": tfm.decompose(self.motion_start if self.use_motion
                                          else cam_to_world),
            "motion_end": tfm.decompose(self.motion_end if self.use_motion
                                        else cam_to_world),
            # the camera's path: S decomposed steps, interpolated piecewise
            # at each lane's shutter time (ops/camera.py)
            "motion_steps": np.int32(len(path)),
            "motion_decomps": np.concatenate(
                [tfm.decompose(t) for t in path]),
            "width": np.int32(self.width),
            "height": np.int32(self.height),
        }
