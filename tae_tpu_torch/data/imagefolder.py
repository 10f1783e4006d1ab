"""ImageFolder dataset, class-per-directory layout, torchvision semantics
(counterpart of ``tae_tpu/data/imagefolder.py``): classes are the sorted
subdirectory names, samples sorted within a class and iterated in order.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator

import numpy as np

_EXTS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp"}


class ImageFolder:
    def __init__(self, root: str | Path,
                 transform: Callable | None = None):
        self.root = Path(root)
        if not self.root.is_dir():
            raise FileNotFoundError(f"ImageFolder root {root!r} does not exist")
        self.classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[Path, int]] = []
        for c in self.classes:
            for p in sorted((self.root / c).rglob("*")):
                if p.suffix.lower() in _EXTS:
                    self.samples.append((p, self.class_to_idx[c]))
        self.transform = transform

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image

        path, target = self.samples[idx]
        img = Image.open(path).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def iter_samples(self, shard_index: int = 0, shard_count: int = 1
                     ) -> Iterator[tuple[np.ndarray, int]]:
        """Sequential sample stream, optionally strided across workers."""
        for i in range(shard_index, len(self.samples), shard_count):
            yield self[i]
