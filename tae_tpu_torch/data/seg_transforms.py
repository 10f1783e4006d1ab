"""Paired image/mask transforms for segmentation (a copy of
``tae_tpu/data/seg_transforms.py`` on the port's ``data/transforms``: the
same image, mask and generator give the same arrays bit for bit).

Reproduces the reference presets (reference segmentation/presets.py:7-37):

  train: RandomResize(0.5·base .. 2·base) -> RandomHorizontalFlip ->
         PadIfSmaller(crop, img 0 / mask 255) -> RandomCrop(crop) ->
         float+Normalize; mask stays int64 with 255 = ignore.
  eval:  Resize((base, base)) exact — image bilinear, mask nearest
         (torchvision v2 resizes Mask tv_tensors with nearest).

Outputs: (C, H, W) float32 image, (H, W) int32 mask.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from tae_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize, to_array

IGNORE = 255


def _mask_to_pil(mask: np.ndarray) -> Image.Image:
    return Image.fromarray(mask.astype(np.uint8), "L")


def _resize_pair(img: Image.Image, mask: np.ndarray, size: tuple[int, int]):
    """size = (width, height); bilinear image, nearest mask."""
    img = img.resize(size, Image.Resampling.BILINEAR)
    m = _mask_to_pil(mask).resize(size, Image.Resampling.NEAREST)
    return img, np.asarray(m, np.uint8)


class SegTrainTransform:
    def __init__(self, base_size: int = 288, crop_size: int = 256,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.min_size = int(0.5 * base_size)
        self.max_size = int(2.0 * base_size)
        self.crop = crop_size
        self.mean, self.std = mean, std

    def __call__(self, img: Image.Image, mask: np.ndarray,
                 rng: np.random.Generator):
        # RandomResize: scale the shorter side into [min, max]
        size = int(rng.integers(self.min_size, self.max_size + 1))
        w, h = img.size
        scale = size / min(w, h)
        img, mask = _resize_pair(img, mask,
                                 (max(1, round(w * scale)), max(1, round(h * scale))))
        if rng.random() < 0.5:
            img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
            mask = mask[:, ::-1]
        # PadIfSmaller: right/bottom pad, img 0 / mask ignore
        w, h = img.size
        pw, ph = max(self.crop - w, 0), max(self.crop - h, 0)
        if pw or ph:
            canvas = Image.new("RGB", (w + pw, h + ph), (0, 0, 0))
            canvas.paste(img, (0, 0))
            img = canvas
            mask = np.pad(mask, ((0, ph), (0, pw)), constant_values=IGNORE)
            w, h = img.size
        top = int(rng.integers(0, h - self.crop + 1))
        left = int(rng.integers(0, w - self.crop + 1))
        img = img.crop((left, top, left + self.crop, top + self.crop))
        mask = mask[top:top + self.crop, left:left + self.crop]
        return (normalize(to_array(img), self.mean, self.std),
                np.ascontiguousarray(mask.astype(np.int32)))


class SegEvalTransform:
    def __init__(self, base_size: int = 256, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.size = base_size
        self.mean, self.std = mean, std

    def __call__(self, img: Image.Image, mask: np.ndarray):
        img, mask = _resize_pair(img, mask, (self.size, self.size))
        return (normalize(to_array(img), self.mean, self.std),
                mask.astype(np.int32))
