"""Image transforms (counterpart of ``tae_tpu/data/transforms.py``).

The host half is the JAX package's, copied as it is so that the same PIL
image and numpy generator give the same array: torchvision's pipelines
reproduced operation for operation,

  * train: RandomResizedCrop(size, scale=[0.2, 1], ratio=[3/4, 4/3],
    bicubic) -> RandomHorizontalFlip -> ToTensor -> Normalize(imagenet);
  * val: Resize(size + 32, bicubic) -> CenterCrop(size) -> ToTensor ->
    Normalize,

with the crop box drawn by torchvision's own procedure (10 area / log-ratio
attempts, then a centre crop) and crop + resize done by one PIL
``resize(box=...)``. Outputs are numpy (C, H, W) float32, normalized. PIL is
imported where an image is handled, never with the module.

The device half normalizes uint8 batches on the device: they cross at a
quarter of fp32's bytes, and /255, -mean, /std become one elementwise pass
there. Its constants are computed in the target dtype, as the JAX package
computes them, so both round alike.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _resample(interpolation: str):
    from PIL import Image

    return {"bicubic": Image.Resampling.BICUBIC,
            "bilinear": Image.Resampling.BILINEAR,
            "nearest": Image.Resampling.NEAREST,
            "lanczos": Image.Resampling.LANCZOS}[interpolation]


def to_array(img) -> np.ndarray:
    """ToTensor: PIL -> float32 (C, H, W) in [0, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def normalize(arr: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
    std = np.asarray(std, np.float32).reshape(-1, 1, 1)
    return (arr - mean) / std


def _sample_rrc_box(rng: np.random.Generator, width: int, height: int,
                    scale: tuple[float, float], ratio: tuple[float, float]
                    ) -> tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: returns (top, left, h, w)."""
    area = float(height * width)
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # fallback: clamp aspect, center crop
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def random_resized_crop_transform(size: int, scale=(0.2, 1.0),
                                  ratio=(3.0 / 4.0, 4.0 / 3.0),
                                  hflip: bool = True,
                                  mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                  interpolation: str = "bicubic",
                                  post=None,
                                  ) -> Callable[..., np.ndarray]:
    """The reference train transform. Takes (PIL image, per-worker RNG).
    ``post``: optional PIL-level hook applied after crop + flip."""

    def apply(img, rng: np.random.Generator) -> np.ndarray:
        box = _sample_rrc_box(rng, img.width, img.height, scale, ratio)
        img = resized_crop(img, size, box, hflip and rng.random() < 0.5,
                           interpolation)
        if post is not None:
            img = post(img, rng)
        return normalize(to_array(img), mean, std)

    return apply


def resized_crop(img, size: int, box: tuple[int, int, int, int], flip: bool,
                 interpolation: str = "bicubic"):
    """The train transform's PIL half, its draws given: the crop ``box``
    (top, left, h, w) resized to ``size`` x ``size`` by one
    ``resize(box=...)``, then flipped left to right if ``flip``."""
    from PIL import Image

    top, left, h, w = box
    img = img.resize((size, size), _resample(interpolation),
                     box=(left, top, left + w, top + h))
    if flip:
        img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
    return img


def resize_shorter(img, size: int, interpolation: str = "bicubic"):
    """torchvision Resize(int): scale shorter side to ``size``, keep aspect."""
    w, h = img.size
    if w <= h:
        new = (size, max(1, int(round(h * size / w))))
    else:
        new = (max(1, int(round(w * size / h))), size)
    return img.resize(new, _resample(interpolation))


def center_crop(img, size: int):
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def center_crop_transform(size: int, pad: int = 32, mean=IMAGENET_MEAN,
                          std=IMAGENET_STD, interpolation: str = "bicubic"
                          ) -> Callable[..., np.ndarray]:
    """The reference val transform: Resize(size+pad) -> CenterCrop(size)."""
    def apply(img) -> np.ndarray:
        img = center_crop(resize_shorter(img, size + pad, interpolation), size)
        return normalize(to_array(img), mean, std)

    return apply


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------

@functools.cache
def _normalize_constants(mean: tuple, std: tuple, dtype: torch.dtype,
                         device: torch.device, p2: int):
    """``(mean · 255, 1 / (std · 255))`` in ``dtype`` on ``device``: per
    channel shaped (C, 1, 1) for images, each channel repeated ``p2`` times
    for pre-patchified rows (``p2`` > 0). Made once and kept, so that a
    request copies nothing from the host (a CUDA graph cannot capture that
    copy; the first request of a captured entry runs eagerly and makes
    them). Plain tensors even when first made under inference mode, since
    a train step reads them too."""
    with torch.inference_mode(False):
        mean = torch.tensor(mean, dtype=dtype, device=device)
        std = torch.tensor(std, dtype=dtype, device=device)
        if p2:
            mean, std = mean.repeat_interleave(p2), std.repeat_interleave(p2)
        else:
            mean, std = mean.reshape(-1, 1, 1), std.reshape(-1, 1, 1)
        return mean * 255.0, 1.0 / (std * 255.0)


def device_normalize(x: torch.Tensor, dtype: torch.dtype | None = None,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """ToTensor + Normalize for uint8 (…, C, H, W) batches."""
    dtype = dtype or torch.float32
    mean, inv = _normalize_constants(tuple(mean), tuple(std), dtype,
                                     x.device, 0)
    return (x.to(dtype) - mean) * inv


def device_normalize_patches(x: torch.Tensor, patch_size: int,
                             dtype: torch.dtype | None = None,
                             mean=IMAGENET_MEAN, std=IMAGENET_STD
                             ) -> torch.Tensor:
    """Normalize for pre-patchified uint8 (…, N, C·p²) batches in
    ``extract_patches`` layout (channel-major per patch)."""
    dtype = dtype or torch.float32
    mean, inv = _normalize_constants(tuple(mean), tuple(std), dtype, x.device,
                                     patch_size * patch_size)
    return (x.to(dtype) - mean) * inv


def maybe_device_normalize(x: torch.Tensor, patch_size: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """uint8 batches are normalized (rank 4: CHW images, rank 3:
    pre-patchified rows); float batches pass through unchanged."""
    if x.dtype != torch.uint8:
        return x
    if x.ndim == 4:
        return device_normalize(x, dtype)
    return device_normalize_patches(x, patch_size, dtype)
