"""COCO -> VOC-21 semantic-segmentation dataset, first-party, without
pycocotools (a copy of ``tae_tpu/data/coco_seg.py``: the same files give
the same masks bit for bit).

Re-creates the reference's segmentation data subsystem
(reference segmentation/coco_utils.py:84-102 + v2_extras.py:29-83):

  * COCO ``instances_*.json`` parsing;
  * the 21-category COCO->VOC label remap (background + 20 VOC classes,
    CAT_LIST order, coco_utils.py:88 / v2_extras.py:43-48);
  * instance-mask merge with overlapping pixels marked invalid (255)
    (v2_extras.py:51-76);
  * train-split filtering: images with no annotations or <=1000 annotated
    pixels in the VOC categories are dropped (coco_utils.py:63-81);
  * mask sources: polygon lists (numpy port of pycocotools' exact
    ``rleFrPoly`` scan conversion, the same integer arithmetic) and both
    RLE forms, uncompressed count lists and pycocotools' compressed LEB128
    string encoding (decoded in numpy);
  * the PASCAL VOC and SBD layouts with their rendered PNG masks.

An independent scalar C++ implementation of the same mask arithmetic
(``native/maskapi.cpp``, bound by :mod:`tae_tpu_torch.data.mask_native`)
holds these decoders in the tests.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

import numpy as np

#: COCO category id -> VOC class index (0 = background), reference order.
CAT_LIST = [0, 5, 2, 16, 9, 44, 6, 3, 17, 62, 21, 67, 18, 19, 4, 1, 64, 20, 63, 7, 72]
COCO_TO_VOC = {c: i for i, c in enumerate(CAT_LIST)}
INVALID = 255


def decode_compressed_rle(counts: str, height: int, width: int) -> np.ndarray:
    """Decode pycocotools' compressed RLE string to a (H, W) uint8 mask.

    Format: base-48-offset chars carrying 6-bit groups, LSB-first, bit 0x20
    as continuation; values are signed; runs after the first two are
    delta-encoded against the value two back. Column-major (Fortran) order.
    """
    runs: list[int] = []
    i = 0
    m = 0
    while i < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if m > 2:
            x += runs[m - 2]
        runs.append(x)
        m += 1
    flat = np.zeros(height * width, np.uint8)
    pos = 0
    val = 0
    for run in runs:
        flat[pos:pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape(width, height).T  # column-major


def decode_rle_counts(counts: list[int], height: int, width: int) -> np.ndarray:
    flat = np.zeros(height * width, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        flat[pos:pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape(width, height).T


def _poly_toggle_positions(xs, ys, height: int, width: int) -> np.ndarray:
    """Column-major fill-toggle positions for one polygon ring — a numpy
    port of pycocotools' ``rleFrPoly`` scan conversion (maskApi.c): vertex
    coords upsampled 5x and rounded, every edge walked densely along its
    major axis, vertical pixel-grid crossings collected where the upsampled
    x changes and lands on a pixel center, each crossing toggling the fill
    state of the rest of its column (even-odd rule). Bit-exact with
    pycocotools by construction (same integer arithmetic)."""
    scale = 5
    x = (scale * np.asarray(xs, np.float64) + 0.5).astype(np.int64)
    y = (scale * np.asarray(ys, np.float64) + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])
    us, vs = [], []
    for j in range(len(x) - 1):
        xs_, xe = int(x[j]), int(x[j + 1])
        ys_, ye = int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs_), abs(ys_ - ye)
        flip = (dx >= dy and xs_ > xe) or (dx < dy and ys_ > ye)
        if flip:
            xs_, xe, ys_, ye = xe, xs_, ye, ys_
        if dx >= dy:
            s = (ye - ys_) / dx if dx else 0.0
            d = np.arange(dx + 1)
            t = dx - d if flip else d
            us.append(t + xs_)
            vs.append((ys_ + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs_) / dy if dy else 0.0
            d = np.arange(dy + 1)
            t = dy - d if flip else d
            vs.append(t + ys_)
            us.append((xs_ + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)
    j = np.nonzero(u[1:] != u[:-1])[0] + 1
    if not len(j):
        return np.empty(0, np.int64)
    uj, ujm1 = u[j], u[j - 1]
    xd = np.where(uj < ujm1, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    ok = (np.floor(xd) == xd) & (xd >= 0) & (xd <= width - 1)
    yd = np.where(v[j] < v[j - 1], v[j], v[j - 1]).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0, height))
    return (xd[ok].astype(np.int64) * height + yd[ok].astype(np.int64))


def rasterize_polygons(polys: list[list[float]], height: int, width: int
                       ) -> np.ndarray:
    """Polygon list ([x0,y0,x1,y1,...] per part) -> (H, W) uint8 mask.

    Per-part masks use pycocotools' exact polygon scan conversion
    (reference segmentation/coco_utils.py:27-41 goes through
    ``coco_mask.frPyObjects``) and parts merge by union, matching the
    reference's ``mask.any(axis=2)`` over per-part decoded masks."""
    mask = np.zeros((height, width), np.uint8)
    for poly in polys:
        if len(poly) >= 6:
            pos = _poly_toggle_positions(poly[0::2], poly[1::2], height, width)
            flat = np.zeros(height * width + 1, np.int64)
            np.add.at(flat, pos, 1)
            mask |= (np.cumsum(flat[:-1]) % 2).astype(np.uint8) \
                .reshape(width, height).T
    return mask


def annotation_mask(ann: dict, height: int, width: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if isinstance(seg, list):
        return rasterize_polygons(seg, height, width)
    if isinstance(seg, dict):
        counts = seg["counts"]
        h, w = seg.get("size", [height, width])
        if isinstance(counts, str):
            return decode_compressed_rle(counts, h, w)
        return decode_rle_counts(counts, h, w)
    return np.zeros((height, width), np.uint8)


def merge_instances_to_voc(anns: list[dict], height: int, width: int
                           ) -> np.ndarray:
    """Merge VOC-mapped instance masks; overlaps -> 255
    (reference v2_extras.py:51-76 semantics)."""
    seg = np.zeros((height, width), np.uint8)
    count = np.zeros((height, width), np.uint16)
    for ann in anns:
        label = COCO_TO_VOC.get(ann.get("category_id"))
        if label is None:
            continue
        m = annotation_mask(ann, height, width).astype(bool)
        seg = np.maximum(seg, np.where(m, np.uint8(label), np.uint8(0)))
        count += m
    seg[count > 1] = INVALID
    return seg


class CocoVocSegmentation:
    """COCO instances -> (PIL image, (H, W) uint8 VOC mask) pairs."""

    def __init__(self, root: str | Path, image_set: str = "train",
                 transforms: Callable | None = None):
        root = Path(root)
        img_dir = {"train": "train2017", "val": "val2017"}[image_set]
        ann_file = root / "annotations" / f"instances_{img_dir}.json"
        self.img_dir = root / img_dir
        data = json.loads(Path(ann_file).read_text())
        self.images = {im["id"]: im for im in data["images"]}
        anns_by_img: dict[int, list[dict]] = {}
        for ann in data["annotations"]:
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.anns_by_img = anns_by_img

        ids = sorted(self.images)
        if image_set == "train":
            # drop images without >1000 annotated px in VOC categories
            # (reference coco_utils.py:63-81; getAnnIds(iscrowd=None) there
            # fetches ALL annotations, so crowd regions count toward the
            # area threshold too)
            def valid(img_id: int) -> bool:
                anns = [a for a in anns_by_img.get(img_id, [])
                        if a.get("category_id") in COCO_TO_VOC]
                return bool(anns) and sum(a.get("area", 0) for a in anns) > 1000

            ids = [i for i in ids if valid(i)]
        self.ids = ids
        self.transforms = transforms

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int):
        from PIL import Image

        info = self.images[self.ids[idx]]
        img = Image.open(self.img_dir / info["file_name"]).convert("RGB")
        # crowd annotations are merged like any other instance: the
        # reference's v2 wrapper (v2_extras.py:51-76 via
        # wrap_dataset_for_transforms_v2) does not filter iscrowd
        anns = list(self.anns_by_img.get(self.ids[idx], []))
        mask = merge_instances_to_voc(anns, info["height"], info["width"])
        if self.transforms is not None:
            return self.transforms(img, mask)
        return img, mask


def load_dataset(name: str, root: str | Path, image_set: str,
                 transforms: Callable | None = None
                 ) -> tuple[Any, int]:
    """Dataset dispatch (reference segmentation/train.py:23-39). VOC and
    SBD('voc_aug') layouts load their pre-rendered PNG masks directly."""
    if name == "coco":
        return CocoVocSegmentation(root, image_set, transforms), 21
    if name in ("voc", "voc_aug"):
        return VocSegmentation(root, image_set, transforms, aug=(name == "voc_aug")), 21
    raise KeyError(f"unknown segmentation dataset {name!r}")


class VocSegmentation:
    """PASCAL VOC 2012 layout: JPEGImages/ + SegmentationClass/ PNG masks +
    ImageSets/Segmentation/{train,val}.txt (SBD: img/ + cls PNG in cls_png/)."""

    def __init__(self, root: str | Path, image_set: str = "train",
                 transforms: Callable | None = None, aug: bool = False):
        root = Path(root)
        if aug:
            img_dir, mask_dir = root / "img", root / "cls_png"
            split = root / f"{image_set}.txt"
        else:
            base = root / "VOCdevkit" / "VOC2012" if (root / "VOCdevkit").exists() else root
            img_dir, mask_dir = base / "JPEGImages", base / "SegmentationClass"
            split = base / "ImageSets" / "Segmentation" / f"{image_set}.txt"
        names = split.read_text().split()
        self.items = [(img_dir / f"{n}.jpg", mask_dir / f"{n}.png") for n in names]
        self.transforms = transforms

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        from PIL import Image

        img_path, mask_path = self.items[idx]
        img = Image.open(img_path).convert("RGB")
        mask = np.asarray(Image.open(mask_path), np.uint8)
        if self.transforms is not None:
            return self.transforms(img, mask)
        return img, mask
