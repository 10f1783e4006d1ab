"""RandAugment (PIL backend), torchvision-compatible op set (a copy of
``tae_tpu/data/randaugment.py``: the same generator draws and PIL ops, so a
seed gives the same image bit for bit).

The reference applies ``transforms.RandAugment()`` (defaults: num_ops=2,
magnitude=9, 31 bins) in the in1k fine-tune train transform
(reference recognition/train_recognition_in1k.py:82). This reimplements the
same 14-op space with torchvision's magnitude ranges and per-op sign flips.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

def _affine(img: Image.Image, matrix, interpolation=Image.Resampling.NEAREST):
    return img.transform(img.size, Image.Transform.AFFINE, matrix,
                         interpolation, fillcolor=0)


def _shear_x(img, mag):  # mag: tangent
    return _affine(img, (1, mag, 0, 0, 1, 0))


def _shear_y(img, mag):
    return _affine(img, (1, 0, 0, mag, 1, 0))


def _translate_x(img, mag):  # mag: pixels
    return _affine(img, (1, 0, -mag, 0, 1, 0))


def _translate_y(img, mag):
    return _affine(img, (1, 0, 0, 0, 1, -mag))


def _rotate(img, mag):  # degrees
    return img.rotate(mag, Image.Resampling.NEAREST, fillcolor=0)


def _brightness(img, mag):
    return ImageEnhance.Brightness(img).enhance(1.0 + mag)


def _color(img, mag):
    return ImageEnhance.Color(img).enhance(1.0 + mag)


def _contrast(img, mag):
    return ImageEnhance.Contrast(img).enhance(1.0 + mag)


def _sharpness(img, mag):
    return ImageEnhance.Sharpness(img).enhance(1.0 + mag)


def _posterize(img, mag):
    return ImageOps.posterize(img, int(mag))


def _solarize(img, mag):
    return ImageOps.solarize(img, int(mag))


def _autocontrast(img, _):
    return ImageOps.autocontrast(img)


def _equalize(img, _):
    return ImageOps.equalize(img)


def _identity(img, _):
    return img


def _op_space(num_bins: int, image_size: tuple[int, int]):
    """torchvision RandAugment._augmentation_space: (magnitudes, signed)."""
    lin = lambda hi: np.linspace(0.0, hi, num_bins)  # noqa: E731
    return {
        "Identity": (_identity, np.zeros(num_bins), False),
        "ShearX": (_shear_x, lin(0.3), True),
        "ShearY": (_shear_y, lin(0.3), True),
        "TranslateX": (_translate_x, lin(150.0 / 331.0 * image_size[0]), True),
        "TranslateY": (_translate_y, lin(150.0 / 331.0 * image_size[1]), True),
        "Rotate": (_rotate, lin(30.0), True),
        "Brightness": (_brightness, lin(0.9), True),
        "Color": (_color, lin(0.9), True),
        "Contrast": (_contrast, lin(0.9), True),
        "Sharpness": (_sharpness, lin(0.9), True),
        "Posterize": (_posterize, 8 - (np.arange(num_bins) / ((num_bins - 1) / 4))
                      .round(), False),
        "Solarize": (_solarize, np.linspace(255.0, 0.0, num_bins), False),
        "AutoContrast": (_autocontrast, np.zeros(num_bins), False),
        "Equalize": (_equalize, np.zeros(num_bins), False),
    }


def rand_augment(img: Image.Image, rng: np.random.Generator,
                 num_ops: int = 2, magnitude: int = 9,
                 num_bins: int = 31) -> Image.Image:
    space = _op_space(num_bins, img.size)
    names = list(space)
    for _ in range(num_ops):
        fn, mags, signed = space[names[int(rng.integers(0, len(names)))]]
        mag = float(mags[magnitude]) if mags.any() else 0.0
        if signed and rng.random() < 0.5:
            mag = -mag
        img = fn(img, mag)
    return img
