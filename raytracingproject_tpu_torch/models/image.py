"""Images for texture nodes (JAX counterpart:
raytracingproject_tpu/models/image.py ImageManager, TextureStore,
build_mip_chain).

The ImageManager collects the images of ImageTextureNodes (numpy arrays;
image files are not ported), converts each to float32 RGBA and packs them
into one zero-padded (slots, Hmax, Wmax, 4) array; a node holds its slot
as a plain int. TextureStore is that array on the render device, handed
to shader evaluation through ShaderData.textures, with the camera pixel
angle the box-filtered checker reads. Images of auto-mip nodes get their
box-filtered pyramid packed as extra slots (mip_slots).
"""

from __future__ import annotations

import numpy as np
import torch


class TextureStore:
    """The packed images on the render device."""

    def __init__(self, data, sizes, mips=None, pixel_angle=None):
        self.data = data          # (S, Hmax, Wmax, 4) float32 tensor
        self.sizes = sizes        # [(h, w)] python ints
        self.mips = dict(mips or {})
        self.pixel_angle = pixel_angle

    def get(self, slot):
        """(image (Hmax, Wmax, 4), h, w) of a slot; a missing image reads
        white."""
        if slot < 0 or slot >= len(self.sizes):
            return self.data[0] * 0 + 1.0, 1, 1
        h, w = self.sizes[slot]
        return self.data[slot], h, w

    @classmethod
    def from_numpy(cls, data, sizes, device, mips=None, pixel_angle=None):
        return cls(torch.tensor(np.asarray(data, np.float32), device=device),
                   [tuple(int(x) for x in s) for s in sizes], mips,
                   pixel_angle)


def _downscale_box(img, limit):
    """Box-filter an image until max(H, W) <= limit."""
    h, w = img.shape[:2]
    while max(h, w) > limit:
        if h % 2:
            img = np.concatenate([img, img[-1:]], 0)
            h += 1
        if w % 2:
            img = np.concatenate([img, img[:, -1:]], 1)
            w += 1
        img = (img[0::2, 0::2] + img[1::2, 0::2]
               + img[0::2, 1::2] + img[1::2, 1::2]) * 0.25
        h, w = img.shape[:2]
    return img


def build_mip_chain(img):
    """Full box-filtered mip pyramid down to 1x1 (level 0 = base)."""
    chain = [img]
    while max(img.shape[:2]) > 1:
        img = _downscale_box(img, max(1, max(img.shape[:2]) // 2))
        chain.append(img)
    return chain


class ImageManager:
    def __init__(self):
        self.images = []   # np (H, W, 4) float32 linear
        self.names = []
        self.texture_limit = 0   # downscale above this extent (0 = off)
        self.want_mips = set()   # slots that need a mip pyramid
        self.mip_slots = {}

    def add_image(self, source, name=""):
        """source: an (H, W[, C]) array. Returns its slot."""
        if isinstance(source, str):
            raise NotImplementedError("image files are not ported (pass "
                                      "the image as an array)")
        arr = np.asarray(source, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
        self.images.append(arr.astype(np.float32))
        self.names.append(name or f"image_{len(self.images)}")
        return len(self.images) - 1

    def device_update(self):
        """Pack every image: (data (S, Hmax, Wmax, 4) float32, sizes);
        mip levels of want_mips slots are appended as extra slots."""
        if not self.images:
            return np.ones((1, 1, 1, 4), np.float32), [(1, 1)]
        imgs = list(self.images)
        if self.texture_limit > 0:
            imgs = [_downscale_box(i, int(self.texture_limit)) for i in imgs]
        self.mip_slots = {}
        extra = []
        for s in sorted(self.want_mips):
            if not (0 <= s < len(imgs)):
                continue
            ids = [s]
            for lvl in build_mip_chain(imgs[s])[1:]:
                ids.append(len(imgs) + len(extra))
                extra.append(lvl)
            self.mip_slots[s] = ids
        imgs = imgs + extra
        hmax = max(i.shape[0] for i in imgs)
        wmax = max(i.shape[1] for i in imgs)
        data = np.zeros((len(imgs), hmax, wmax, 4), np.float32)
        sizes = []
        for s, img in enumerate(imgs):
            h, w = img.shape[:2]
            data[s, :h, :w] = img
            sizes.append((h, w))
        return data, sizes
