"""Camera ray generation (JAX counterpart:
raytracingproject_tpu/ops/camera.py camera_sample_ray).

The perspective camera with its thin lens (a disk, or a polygon of
`blades` sides, scaled by `aperturesize` and `aperture_ratio`, focused at
`focaldistance`) and its motion path (the camera-to-world of each lane
interpolated at the lane's shutter time). Orthographic and panorama
cameras and rolling shutter raise NotImplementedError.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.utils import math as um
from raytracingproject_tpu_torch.utils import transform as tfm

CAMERA_PERSPECTIVE = 0


def camera_sample_ray(cam, raster_x, raster_y, lens_u, lens_v, time_u):
    """World-space camera rays for (N,) raster positions (already
    filter-jittered), (N,) lens samples and (N,) shutter samples. `cam` is
    the Camera.update() record. Returns dict o, d (N, 3) and tmin, tmax,
    time (N,)."""
    if int(cam["type"]) != CAMERA_PERSPECTIVE:
        raise NotImplementedError("only the perspective camera is ported")
    if int(cam["rolling_shutter_type"]) != 0:
        raise NotImplementedError("rolling shutter is not ported")
    dev = raster_x.device
    r2c = torch.as_tensor(cam["raster_to_camera"], device=dev)
    ones = torch.ones_like(raster_x)
    praster = torch.stack([raster_x, raster_y, ones], -1)
    pcam = um.mat34_point(r2c, praster)
    d = torch.cat([pcam[..., 0:2], ones[..., None]], -1)
    o = torch.zeros_like(d)
    aperture = float(cam["aperturesize"])
    if aperture > 0.0:
        blades = int(cam["blades"])
        if blades >= 3:
            lx, ly = um.regular_polygon_sample(
                float(blades), float(cam["bladesrotation"]), lens_u, lens_v)
        else:
            lx, ly = um.concentric_sample_disk(lens_u, lens_v)
        lx = lx * aperture
        ly = ly * aperture / max(float(cam["aperture_ratio"]), 1e-6)
        # the focal plane along the un-normalised direction (z = 1)
        ft = float(cam["focaldistance"]) / torch.clamp(d[..., 2], min=1e-8)
        o = torch.stack([lx, ly, torch.zeros_like(lx)], -1)
        d = d * ft[..., None] - o
    d = um.normalize(d)
    if int(cam["use_motion"]):
        # in float64, then rounded once: the slerp and the normalisation
        # of float32 quaternions round the rotation by a few float32 ulps,
        # and a camera ray that grazes an edge turns on such an ulp
        c2w = tfm.motion_interpolate_steps(
            torch.as_tensor(cam["motion_decomps"], device=dev).double(),
            time_u.double(), int(cam["motion_steps"])).float()
    else:
        c2w = torch.as_tensor(cam["cam_to_world"], device=dev)
    o_w = um.mat34_point(c2w, o)
    d_w = um.normalize(um.mat34_dir(c2w, d))
    nearclip = float(cam["nearclip"])
    if nearclip > 0.0:
        o_w = o_w + d_w * nearclip
    cliplen = float(cam["cliplength"])
    tmax = torch.full_like(raster_x, cliplen if cliplen > 0 else um.RAY_TMAX)
    return {"o": o_w, "d": d_w, "tmin": torch.zeros_like(raster_x),
            "tmax": tmax, "time": time_u}
