"""Synthetic data: fake webdataset shards and ImageFolder trees in the
on-disk formats the drivers read (counterpart of the generators of
``tae_tpu/data/fake.py`` that the tests and ``chip_smoke.py`` use; the same
seed gives the same bytes).
"""

from __future__ import annotations

import io
import tarfile
from pathlib import Path

import numpy as np


def _random_jpeg(rng: np.random.Generator, size: int, quality: int = 90) -> bytes:
    from PIL import Image

    arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    img = Image.fromarray(arr, "RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def make_fake_wds_shard(path: str | Path, num_samples: int = 32, size: int = 64,
                        num_classes: int = 10, seed: int = 0) -> Path:
    """Write a ``{key}.jpg`` + ``{key}.cls`` tar shard (webdataset layout)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(num_samples):
            key = f"{i:06d}"
            jpg = _random_jpeg(rng, size)
            cls = str(int(rng.integers(0, num_classes))).encode()
            for ext, data in (("jpg", jpg), ("cls", cls)):
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return path


def make_fake_imagefolder(root: str | Path, num_classes: int = 3,
                          per_class: int = 4, size: int = 64,
                          seed: int = 0) -> Path:
    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    for c in range(num_classes):
        d = root / f"class_{c:03d}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            Image.fromarray(arr, "RGB").save(d / f"img_{i:04d}.jpg", quality=95)
    return root
