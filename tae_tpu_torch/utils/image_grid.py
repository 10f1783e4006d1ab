"""Reconstruction-grid image dumps (counterpart of
``tae_tpu/utils/image_grid.py``, numpy and PIL, copied as it is): the
equivalent of ``torchvision.utils.save_image(..., nrow=8, padding=1,
normalize=True, scale_each=True)``, which the reference's displays use. Each
image is min-max normalized on its own, laid out row-major in a padded grid
and written with PIL.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _scale_each(imgs: np.ndarray) -> np.ndarray:
    """Per-image min-max to [0, 1]. imgs: (N, C, H, W) float."""
    flat = imgs.reshape(imgs.shape[0], -1)
    lo = flat.min(axis=1).reshape(-1, 1, 1, 1)
    hi = flat.max(axis=1).reshape(-1, 1, 1, 1)
    return (imgs - lo) / np.maximum(hi - lo, 1e-5)


def make_grid(imgs: np.ndarray, nrow: int = 8, padding: int = 1,
              pad_value: float = 0.0) -> np.ndarray:
    """(N, C, H, W) in [0,1] -> (C, gh·(H+p)+p, gw·(W+p)+p) grid array."""
    n, c, h, w = imgs.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    gh = nrows * (h + padding) + padding
    gw = ncol * (w + padding) + padding
    grid = np.full((c, gh, gw), pad_value, dtype=np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[:, y:y + h, x:x + w] = imgs[idx]
    return grid


def save_image(imgs, path: str | Path, nrow: int = 8, padding: int = 1,
               normalize: bool = True, scale_each: bool = True) -> None:
    from PIL import Image

    arr = np.asarray(imgs, dtype=np.float32)
    if normalize:
        arr = _scale_each(arr) if scale_each else \
            (arr - arr.min()) / max(arr.max() - arr.min(), 1e-5)
    grid = make_grid(np.clip(arr, 0.0, 1.0), nrow=nrow, padding=padding)
    u8 = (grid * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(u8).save(path)
