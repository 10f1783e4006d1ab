"""MixUp and CutMix batch augmentation (collate-level, numpy; a copy of
``tae_tpu/data/mixup.py``, so a seed gives the same batches bit for bit).

Replaces the torchvision v2 transforms the reference uses for the in1k
fine-tune (reference recognition/train_recognition_in1k.py:53-57,89-90:
``RandomChoice([MixUp(alpha=0.2), CutMix(alpha=1.0)])`` applied in the
collate function). Semantics follow torchvision: targets become soft label
distributions; the batch is mixed with itself rolled by one.
"""

from __future__ import annotations

import numpy as np


def one_hot(targets: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((targets.shape[0], num_classes), np.float32)
    out[np.arange(targets.shape[0]), targets] = 1.0
    return out


def mixup(imgs: np.ndarray, targets: np.ndarray, num_classes: int,
          alpha: float, rng: np.random.Generator
          ) -> tuple[np.ndarray, np.ndarray]:
    """imgs (B,C,H,W), integer targets (B,) -> mixed imgs + soft targets."""
    lam = float(rng.beta(alpha, alpha))
    y = one_hot(targets, num_classes)
    imgs = lam * imgs + (1.0 - lam) * np.roll(imgs, 1, axis=0)
    y = lam * y + (1.0 - lam) * np.roll(y, 1, axis=0)
    return imgs.astype(np.float32), y


def cutmix(imgs: np.ndarray, targets: np.ndarray, num_classes: int,
           alpha: float, rng: np.random.Generator
           ) -> tuple[np.ndarray, np.ndarray]:
    """Paste a random box from the rolled batch; label weight = box area."""
    b, c, h, w = imgs.shape
    lam = float(rng.beta(alpha, alpha))
    r = 0.5 * np.sqrt(1.0 - lam)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    rh, rw = int(r * h * 2), int(r * w * 2)
    y1, y2 = max(cy - rh // 2, 0), min(cy + rh // 2, h)
    x1, x2 = max(cx - rw // 2, 0), min(cx + rw // 2, w)
    out = imgs.copy()
    rolled = np.roll(imgs, 1, axis=0)
    out[:, :, y1:y2, x1:x2] = rolled[:, :, y1:y2, x1:x2]
    box_area = (y2 - y1) * (x2 - x1)
    lam_adj = 1.0 - box_area / float(h * w)
    y = one_hot(targets, num_classes)
    y = lam_adj * y + (1.0 - lam_adj) * np.roll(y, 1, axis=0)
    return out.astype(np.float32), y


def mixup_cutmix_collate(num_classes: int, mixup_alpha: float = 0.2,
                         cutmix_alpha: float = 1.0, seed: int = 0):
    """Random per-batch choice of MixUp or CutMix, as a collate function for
    BatchLoader (imgs, int targets) batches."""
    rng = np.random.default_rng(seed)

    def collate(batch: tuple[np.ndarray, np.ndarray]):
        imgs, targets = batch
        if rng.random() < 0.5:
            return mixup(imgs, targets, num_classes, mixup_alpha, rng)
        return cutmix(imgs, targets, num_classes, cutmix_alpha, rng)

    return collate
