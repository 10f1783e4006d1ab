"""Synthetic data: fake webdataset shards, ImageFolder trees and COCO
instance layouts in the on-disk formats the drivers read (counterpart of
``tae_tpu/data/fake.py``; the same seed gives the same bytes): pure noise for
the drivers' plumbing, and the learnable corpora (structured, spectral and
class-anchored images) that convergence runs train on.
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


def make_fake_coco(root: str | Path, n_train: int = 8, n_val: int = 4,
                   size: int = 64, seed: int = 0) -> Path:
    """Minimal COCO instances layout with polygon annotations in VOC
    categories (rectangles, area > the reference's 1000px train filter)."""
    import json

    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        (root / split).mkdir(parents=True, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in range(n):
            name = f"{i:012d}.jpg"
            arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            Image.fromarray(arr, "RGB").save(root / split / name, quality=90)
            images.append({"id": i + 1, "file_name": name,
                           "height": size, "width": size})
            # one big rectangle (valid) + occasionally a tiny one (filtered)
            x0, y0 = int(rng.integers(0, size // 3)), int(rng.integers(0, size // 3))
            w = h = size // 2
            cat = int(rng.choice([1, 5, 2, 16, 9]))  # VOC-mapped categories
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": cat,
                "segmentation": [[x0, y0, x0 + w, y0, x0 + w, y0 + h, x0, y0 + h]],
                "area": float(w * h), "iscrowd": 0,
                "bbox": [x0, y0, w, h]})
            ann_id += 1
        (root / "annotations").mkdir(parents=True, exist_ok=True)
        (root / "annotations" / f"instances_{split}.json").write_text(json.dumps({
            "images": images, "annotations": annotations,
            "categories": [{"id": c, "name": str(c)} for c in range(1, 91)]}))
    return root


def _structured_image(rng: np.random.Generator, size: int,
                      colors: tuple | None = None,
                      top_ellipse_color: np.ndarray | None = None,
                      num_shapes: int | None = None) -> np.ndarray:
    """A natural-image-like synthetic composition: smooth gradient sky,
    colored soft-edged shapes at multiple scales, and low-pass texture.

    Pure noise (``_random_jpeg``) carries no learnable structure: an
    autoencoder cannot compress it through a narrow bottleneck, so its MSE
    plateaus at once. These images have the strong spatial correlation that
    reconstruction training exploits, so loss trajectories on them are
    convergence evidence (``tae_tpu_torch.scripts.convergence``), and a
    segmentation head can learn from them.

    ``colors`` pins the gradient endpoint colors, ``top_ellipse_color``
    adds one large never-occluded center ellipse, and ``num_shapes``
    overrides the random shape count — hooks for the class-conditioned
    generators (labels must survive composition to be learnable)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    if colors is None:
        c0 = rng.uniform(0, 255, 3).astype(np.float32)
        c1 = rng.uniform(0, 255, 3).astype(np.float32)
    else:
        c0, c1 = (np.asarray(c, np.float32) for c in colors)
    ang = rng.uniform(0, 2 * np.pi)
    t = (np.cos(ang) * xx + np.sin(ang) * yy)[..., None]
    t = (t - t.min()) / (t.max() - t.min() + 1e-6)
    img = c0 + (c1 - c0) * t                          # gradient background
    n_shapes = int(rng.integers(4, 10)) if num_shapes is None else num_shapes
    for _ in range(n_shapes):                          # soft ellipses
        cx, cy = rng.uniform(0, 1, 2)
        rx, ry = rng.uniform(0.05, 0.45, 2)
        theta = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        u = (np.cos(theta) * dx + np.sin(theta) * dy) / rx
        v = (-np.sin(theta) * dx + np.cos(theta) * dy) / ry
        d = u * u + v * v
        alpha = np.clip(1.5 - d * 1.5, 0.0, 1.0)[..., None]  # soft edge
        col = rng.uniform(0, 255, 3).astype(np.float32)
        img = img * (1 - alpha) + col * alpha
    if top_ellipse_color is not None:   # class-colored, drawn last (on top)
        cx, cy = rng.uniform(0.35, 0.65, 2)
        rx, ry = rng.uniform(0.22, 0.38, 2)
        d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
        alpha = np.clip(1.5 - d * 1.5, 0.0, 1.0)[..., None]
        col = np.asarray(top_ellipse_color, np.float32)
        img = img * (1 - alpha) + col * alpha
    # low-pass texture: upsampled coarse noise (cheap separable repeat)
    g = int(rng.integers(4, 16))
    tex = rng.normal(0, rng.uniform(4, 24), (g, g, 3)).astype(np.float32)
    tex = np.repeat(np.repeat(tex, -(-size // g), 0), -(-size // g), 1)
    img = img + tex[:size, :size]
    return np.clip(img, 0, 255).astype(np.uint8)


def make_structured_wds_shard(path: str | Path, num_samples: int = 1000,
                              size: int = 288, num_classes: int = 1000,
                              seed: int = 0, quality: int = 90) -> Path:
    """Like :func:`make_fake_wds_shard` but with structured (learnable)
    images — the convergence-run fixture."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(num_samples):
            key = f"{i:06d}"
            buf = io.BytesIO()
            Image.fromarray(_structured_image(rng, size), "RGB").save(
                buf, format="JPEG", quality=quality)
            jpg = buf.getvalue()
            cls = str(int(rng.integers(0, num_classes))).encode()
            for ext, data in (("jpg", jpg), ("cls", cls)):
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return path


def _spectral_image(rng: np.random.Generator, size: int,
                    alpha: float = 1.0) -> np.ndarray:
    """A power-law (1/f^alpha) random field — the high-information-rate
    convergence fixture.

    The structured corpus (:func:`_structured_image`) is *too* compressible
    for bottleneck-width sweeps: 16 latent dims per 16x16 patch already
    capture it, so tae_patch16_vocab{16,64,256} all track the same eval
    curve (measured, docs/CONVERGENCE.md). These images carry a natural-
    image-like power spectrum with substantial energy at mid/high spatial
    frequencies, so per-patch intrinsic dimensionality is in the hundreds
    and the reconstruction floor strictly improves with bottleneck width —
    the regime where the reference's published eval-MSE-vs-vocab ordering
    (reference outputs/, SURVEY.md §6) can emerge at short horizons.
    Channels are mixed for realistic cross-channel correlation."""
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    radius = np.sqrt(fx * fx + fy * fy)
    filt = (radius + 1.0 / size) ** (-alpha)
    spec = np.fft.rfft2(rng.standard_normal((3, size, size))) * filt
    x = np.fft.irfft2(spec, s=(size, size))
    mix = np.eye(3, dtype=np.float64) + 0.6 * rng.standard_normal((3, 3))
    x = np.einsum("ij,jhw->ihw", mix, x)
    x -= x.mean(axis=(1, 2), keepdims=True)
    x /= x.std(axis=(1, 2), keepdims=True) + 1e-9
    img = 127.0 + 52.0 * x
    return np.clip(img, 0, 255).astype(np.uint8).transpose(1, 2, 0)


def make_spectral_wds_shard(path: str | Path, num_samples: int = 1000,
                            size: int = 288, num_classes: int = 1000,
                            seed: int = 0, alpha: float = 1.0,
                            quality: int = 95) -> Path:
    """wds shard of :func:`_spectral_image` samples (quality 95: the point
    is high-frequency content; don't let JPEG eat it)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(num_samples):
            key = f"{i:06d}"
            buf = io.BytesIO()
            Image.fromarray(_spectral_image(rng, size, alpha), "RGB").save(
                buf, format="JPEG", quality=quality)
            jpg = buf.getvalue()
            cls = str(int(rng.integers(0, num_classes))).encode()
            for ext, data in (("jpg", jpg), ("cls", cls)):
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return path


def make_spectral_imagefolder(root: str | Path, num_images: int = 512,
                              size: int = 288, seed: int = 10_000,
                              alpha: float = 1.0) -> Path:
    """Spectral-image val set (single class dir; eval only needs images)."""
    from PIL import Image

    root = Path(root)
    d = root / "class_000"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(num_images):
        Image.fromarray(_spectral_image(rng, size, alpha), "RGB").save(
            d / f"img_{i:05d}.jpg", quality=95)
    return root


def make_classification_wds_shard(path: str | Path, num_samples: int = 500,
                                  size: int = 288, num_classes: int = 20,
                                  seed: int = 0, quality: int = 90) -> Path:
    """Structured wds shard with LEARNABLE ``cls`` labels.

    ``make_structured_wds_shard`` draws labels independently of pixels
    (reconstruction training ignores them); here the class id
    deterministically anchors the background-gradient color pair and the
    color of one large always-on-top center ellipse (small per-instance
    jitter), while shape layout and texture stay random. Any reasonable
    frozen encoder preserves color statistics, so a downstream classifier
    separates these well above chance — the on-chip downstream-convergence
    fixture (docs/CONVERGENCE.md). Mirrors the (jpg, cls) sample layout the
    reference's recognition stream consumes
    (recognition/train_recognition_in19k.py:76-88)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(num_samples):
            cls = int(rng.integers(0, num_classes))
            anchor = np.random.default_rng(1000 + cls)
            c0, c1, dom = (anchor.uniform(30, 225, 3).astype(np.float32)
                           for _ in range(3))
            jit = rng.uniform(-12, 12, (3, 3)).astype(np.float32)
            # fewer random distractor shapes than the reconstruction
            # fixture: they occlude the class-anchored colors (measured in
            # tests: between-class mean-color distance vs within-class
            # spread needs >2x for a clean learnability margin)
            img = _structured_image(rng, size,
                                    colors=(c0 + jit[0], c1 + jit[1]),
                                    top_ellipse_color=dom + jit[2],
                                    num_shapes=int(rng.integers(2, 5)))
            buf = io.BytesIO()
            Image.fromarray(img, "RGB").save(buf, format="JPEG",
                                             quality=quality)
            jpg = buf.getvalue()
            for ext, data in (("jpg", jpg), ("cls", str(cls).encode())):
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return path


def make_classification_imagefolder(root: str | Path, num_images: int = 400,
                                    size: int = 288, num_classes: int = 20,
                                    seed: int = 0) -> Path:
    """ImageFolder counterpart of :func:`make_classification_wds_shard` —
    same class-anchored colors (class ``c`` uses anchor rng ``1000 + c``,
    so features learned on the wds fixture transfer), ``class_%03d/``
    subdirectories in torchvision ImageFolder layout. Drives the in1k
    fine-tune trainer (reference recognition/train_recognition_in1k.py:96-101
    builds ImageFolder('train'/'val') datasets)."""
    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    for i in range(num_images):
        cls = i % num_classes
        anchor = np.random.default_rng(1000 + cls)
        c0, c1, dom = (anchor.uniform(30, 225, 3).astype(np.float32)
                       for _ in range(3))
        jit = rng.uniform(-12, 12, (3, 3)).astype(np.float32)
        img = _structured_image(rng, size,
                                colors=(c0 + jit[0], c1 + jit[1]),
                                top_ellipse_color=dom + jit[2],
                                num_shapes=int(rng.integers(2, 5)))
        d = root / f"class_{cls:03d}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img, "RGB").save(d / f"img_{i:06d}.jpg", quality=90)
    return root


def make_structured_coco(root: str | Path, n_train: int = 64, n_val: int = 16,
                         size: int = 288, seed: int = 0) -> Path:
    """COCO instances layout with LEARNABLE segmentation: each image holds
    2-4 hard-edged ellipses on a gradient background; the ellipse fill
    color is a deterministic function of its (VOC-mapped) COCO category,
    and the polygon annotation traces the same ellipse — so a segmentation
    head can learn color->class while the mask supervision is spatially
    exact. Categories cycle over the 20 VOC foreground classes
    (data/coco_seg.py:CAT_LIST; reference segmentation/coco_utils.py:88);
    ellipse areas clear the 1000px train filter (coco_utils.py:75-83)."""
    import json

    from PIL import Image

    from tae_tpu_torch.data.coco_seg import CAT_LIST

    root = Path(root)
    rng = np.random.default_rng(seed)
    cats = [c for c in CAT_LIST if c != 0]  # 20 foreground categories

    def cat_color(cat: int) -> np.ndarray:
        return np.random.default_rng(2000 + cat).uniform(
            40, 255, 3).astype(np.float32)

    for split, n in (("train2017", n_train), ("val2017", n_val)):
        (root / split).mkdir(parents=True, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in range(n):
            name = f"{i:012d}.jpg"
            img = _structured_image(rng, size, num_shapes=0)  # background only
            imgf = img.astype(np.float32)
            yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
            # 2x2 quadrant grid keeps ellipses disjoint (bounded 255-overlap)
            quads = rng.permutation(4)[:int(rng.integers(2, 5))]
            for q in quads:
                qx, qy = q % 2, q // 2
                cx = (qx + rng.uniform(0.4, 0.6)) * size / 2
                cy = (qy + rng.uniform(0.4, 0.6)) * size / 2
                rx = rng.uniform(0.10, 0.21) * size
                ry = rng.uniform(0.10, 0.21) * size
                cat = int(cats[int(rng.integers(0, len(cats)))])
                col = cat_color(cat) + rng.uniform(-10, 10, 3).astype(np.float32)
                inside = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1.0
                imgf[inside] = np.clip(col, 0, 255)
                t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
                poly = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)],
                                axis=1).ravel()
                annotations.append({
                    "id": ann_id, "image_id": i + 1, "category_id": cat,
                    "segmentation": [np.round(poly, 2).tolist()],
                    "area": float(np.pi * rx * ry), "iscrowd": 0,
                    "bbox": [float(cx - rx), float(cy - ry),
                             float(2 * rx), float(2 * ry)]})
                ann_id += 1
            Image.fromarray(np.clip(imgf, 0, 255).astype(np.uint8),
                            "RGB").save(root / split / name, quality=92)
            images.append({"id": i + 1, "file_name": name,
                           "height": size, "width": size})
        (root / "annotations").mkdir(parents=True, exist_ok=True)
        (root / "annotations" / f"instances_{split}.json").write_text(
            json.dumps({"images": images, "annotations": annotations,
                        "categories": [{"id": c, "name": str(c)}
                                       for c in range(1, 91)]}))
    return root


def make_structured_imagefolder(root: str | Path, num_images: int = 512,
                                size: int = 288, seed: int = 10_000) -> Path:
    """Structured-image val set (single class dir; eval only needs images)."""
    from PIL import Image

    root = Path(root)
    d = root / "class_000"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(num_images):
        Image.fromarray(_structured_image(rng, size), "RGB").save(
            d / f"img_{i:05d}.jpg", quality=90)
    return root
