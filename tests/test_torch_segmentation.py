"""The port's segmentation ViT, its criterion, the confusion matrix and the
segmentation data code (COCO / VOC, mask decoders, paired transforms)
against the JAX package's, on the CPU.

Models: the JAX model's parameters reach the port through
``ckpt.bridge.segmentation_state_dict_from_jax``; both run the same numpy
latents, at 256 tokens (K2 on the card) and at 4 (the tiny-N entry, K6),
with the auxiliary head tapped after 3 of 4 blocks. The data code is a copy:
the same files, images and generators give bit-equal arrays.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.torch_export import save_torch_checkpoint
from tae_tpu.cli import train_segmentation as jseg
from tae_tpu.data import coco_seg as jcoco
from tae_tpu.data import fake as jfake
from tae_tpu.data import seg_transforms as jst
from tae_tpu.utils import confusion as jconf
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import segmentation_state_dict_from_jax
from tae_tpu_torch.ckpt.io import load_params
from tae_tpu_torch.cli import train_segmentation as seg
from tae_tpu_torch.data import coco_seg, fake, mask_native, seg_transforms
from tae_tpu_torch.nn import vit
from tae_tpu_torch.utils.confusion import ConfusionMatrix
from tae_tpu_torch.utils.dtypes import FP32, Policy

TINY = dict(vocab_size=16, decoder_embed_dim=48, decoder_depth=4,
            decoder_num_heads=4, num_classes=5)
# (name, patch size): 256 tokens of 4 px, and 4 tokens of 32 px
CONFIGS = {"n256": ("vit_segmentation_numpatches256_vocab16_base", 4),
           "n4": ("vit_segmentation_numpatches4_vocab1024_base", 32)}
# fp32 forward, relative (Frobenius): the same ops summed in other orders
FP32_REL = 1e-5
# bf16 compute: rounding at each side's own points (test_torch_model.py)
BF16_REL = 2e-2
# fp32 gradients of one step, relative (Frobenius) per tensor
GRAD_REL = 1e-4
# the masked cross-entropy in fp32 on the same logits
LOSS_TOL = 1e-6


def _rel(got: torch.Tensor, want) -> float:
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().float().numpy() - w)
                 / max(np.linalg.norm(w), 1e-30))


def _pair(cfg, seed=0, trainable=False):
    name, p = CONFIGS[cfg]
    jm = jmodels.create(name, patch_size=p, **TINY)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    tm = models.create(name, patch_size=p, trainable=trainable, **TINY)
    tm.load_state_dict(segmentation_state_dict_from_jax(params, jm.cfg),
                       strict=True)
    return jm, params, tm


def _latents(jm, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, jm.cfg.num_patches, jm.cfg.vocab_size)
                               ).astype(np.float32)


def _target(jm, b=2, seed=3, ignored=0.1):
    rng = np.random.default_rng(seed)
    size = int(round(jm.cfg.num_patches ** 0.5)) * jm.cfg.patch_size
    t = rng.integers(0, jm.cfg.num_classes, (b, size, size)).astype(np.int32)
    t[rng.random(t.shape) < ignored] = 255
    return t


# ------------------------------------------------------------------- model

@pytest.mark.parametrize("backend", [None, "kernel"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_forward_matches_jax(cfg, policy, backend):
    jm, params, tm = _pair(cfg)
    assert tm.cfg.aux_depth == jm.cfg.aux_depth == 3
    z = _latents(jm)
    jpol, pol, tol = ((J_FP32, FP32, FP32_REL) if policy == "fp32"
                      else (JPolicy(), Policy(), BF16_REL))
    want = jm.forward(params, jnp.asarray(z), policy=jpol)
    with torch.no_grad():
        got = tm(torch.from_numpy(z), policy=pol, backend=backend)
    assert set(got) == {"out", "aux"}
    for k in ("out", "aux"):
        assert got[k].shape == want[k].shape == (2, 5, 64, 64)
        assert _rel(got[k], jnp.asarray(want[k], jnp.float32)) < tol, k


@pytest.mark.parametrize("backend", [None, "kernel"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_train_step_gradients_match_jax(cfg, backend):
    """The criterion out + 0.5 aux of one train step and every parameter's
    gradient against jax.grad of the JAX driver's criterion, fp32."""
    jm, params, tm = _pair(cfg, trainable=True)
    z, t = _latents(jm), _target(jm)

    def jloss(p):
        return jseg.criterion(jm.forward(p, jnp.asarray(z), policy=J_FP32),
                              jnp.asarray(t))

    loss_j, grads_j = jax.value_and_grad(jloss)(params)
    want = segmentation_state_dict_from_jax(jax.tree.map(np.asarray, grads_j))
    loss = seg.criterion(tm(torch.from_numpy(z), policy=FP32, backend=backend),
                         torch.from_numpy(t))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= FP32_REL * float(loss_j)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert _rel(p.grad, want[k].numpy()) < GRAD_REL, k


def test_every_layer_norm_gets_contiguous_aligned_rows():
    """The LayerNorm kernel (K1 and its training forms) refuses a
    non-contiguous or unaligned x on the card. Every LayerNorm of the
    segmentation model, the auxiliary tap's in the middle of the trunk
    included, is handed a contiguous, 16-byte aligned tensor, forward and
    with remat; a view of the residual stream is not one."""
    jm, params, tm = _pair("n256", trainable=True)
    seen = []

    def note(module, args):
        x = args[0]
        seen.append((x.is_contiguous(), x.data_ptr() % 16 == 0))

    hooks = [m.register_forward_pre_hook(note) for m in tm.modules()
             if isinstance(m, vit.LayerNorm)]
    try:
        for remat in (False, True):
            out = tm(torch.from_numpy(_latents(jm)), policy=Policy(),
                     backend="kernel", remat=remat)
            seg.criterion(out, torch.from_numpy(_target(jm))).backward()
    finally:
        for h in hooks:
            h.remove()
    # per forward: 2 a block, the final and the auxiliary norm; remat
    # recomputes the blocks' norms
    assert len(seen) == (2 * 4 + 2) + (2 * 4 + 2 + 2 * 4)
    assert all(c and a for c, a in seen)
    x = torch.randn(2, 16, 48)
    assert not x[:, ::2].is_contiguous()


def test_replace_head_swaps_both_heads():
    jm, params, tm = _pair("n256", trainable=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.replace_head(3, torch.Generator().manual_seed(5))
    jm3, jp3 = jm.replace_head(params, jax.random.key(5), 3)
    assert tm.cfg.num_classes == jm3.cfg.num_classes == 3
    for head in ("head", "aux_head"):
        w = getattr(tm, head).weight
        assert tuple(w.shape) == (4 * 4 * 3, 48)
        assert np.asarray(jp3[head]["w"]).shape == (48, 4 * 4 * 3)
        assert w.requires_grad
    assert not torch.equal(tm.head.weight, tm.aux_head.weight)
    sd = tm.state_dict()
    for k, v in before.items():
        if k.split(".")[0] not in ("head", "aux_head"):
            assert torch.equal(sd[k], v), k
    out = tm(torch.from_numpy(_latents(jm)), policy=FP32)
    assert out["out"].shape == out["aux"].shape == (2, 3, 64, 64)


def test_reference_state_dict_loads_through_load_params(tmp_path):
    from tae_tpu.ckpt.torch_export import segmentation_state_dict

    jm, params, _ = _pair("n4")
    save_torch_checkpoint(tmp_path / "seg.pth", jm, params)
    name, p = CONFIGS["n4"]
    tm = models.create(name, patch_size=p, **TINY)
    tm.init_weights_(torch.Generator().manual_seed(0))
    load_params(tmp_path / "seg.pth", tm)
    want = segmentation_state_dict_from_jax(params)
    assert set(tm.state_dict()) == set(want) == set(
        segmentation_state_dict(params, jm.cfg))
    assert all(torch.equal(tm.state_dict()[k], want[k]) for k in want)


def test_mesh_is_refused():
    _, _, tm = _pair("n4")
    with pytest.raises(NotImplementedError, match="A13"):
        tm(torch.zeros(1, 4, 16), mesh=object())


def test_registry_matches_jax():
    names = models.list_models("vit_segmentation")
    assert names == jmodels.list_models("vit_segmentation") and len(names) == 12
    for name in names:
        cfg = models.create(name, device="meta").cfg
        jcfg = jmodels.create(name).cfg
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        # the patch size follows the token grid: every config predicts 256 px
        assert int(cfg.num_patches ** 0.5) * cfg.patch_size == 256
    tm = models.create("vit_segmentation_numpatches256_vocab256_base",
                       device="meta")
    shapes = jax.eval_shape(jmodels.create(
        "vit_segmentation_numpatches256_vocab256_base").init, jax.random.key(0))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tuple(tm.head.weight.shape) == (16 * 16 * 21, 768)


# --------------------------------------------------------------- criterion

@pytest.mark.parametrize("ignored", [0.0, 0.3, 1.0])
def test_masked_cross_entropy_matches_jax(ignored):
    """Mean over the pixels not marked 255; where every pixel is 255 the
    loss is 0 (the JAX criterion's max(valid, 1)), not torch's NaN."""
    rng = np.random.default_rng(0)
    logits = (2 * rng.standard_normal((2, 4, 8, 8))).astype(np.float32)
    target = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    target[rng.random(target.shape) < ignored] = 255
    want = float(jseg.masked_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(target)))
    got = seg.masked_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(target))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= LOSS_TOL * max(abs(want), 1.0)
    if ignored == 1.0:
        assert float(got) == 0.0
        assert torch.isnan(torch.nn.functional.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(target).long(),
            ignore_index=255))
    else:
        ref = torch.nn.functional.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(target).long(),
            ignore_index=255)
        assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)


def test_all_ignored_batch_has_zero_gradient():
    logits = torch.randn(1, 3, 4, 4, requires_grad=True)
    loss = seg.criterion({"out": logits, "aux": logits},
                         torch.full((1, 4, 4), 255))
    loss.backward()
    assert float(loss.detach()) == 0.0 and float(logits.grad.abs().max()) == 0.0


# --------------------------------------------------------------- confusion

@pytest.mark.parametrize("seed", range(3))
def test_confusion_matrix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cm, jcm = ConfusionMatrix(6), jconf.ConfusionMatrix(6)
    for _ in range(3):
        target = rng.integers(0, 6, (2, 9, 7)).astype(np.int64)
        target[rng.random(target.shape) < 0.2] = 255
        target[0, 0, :3] = [-1, 6, 7]                # outside [0, C): dropped
        pred = rng.integers(0, 6, (2, 9, 7))
        if seed == 2:
            pred[:] = 2                              # classes never predicted
        cm.update(torch.from_numpy(target), torch.from_numpy(pred))
        jcm.update(target, pred)
    np.testing.assert_array_equal(cm.mat, jcm.mat)
    assert cm.mat.dtype == np.int64
    a, b = cm.compute(), jcm.compute()
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    assert cm.mean_iou == jcm.mean_iou or (np.isnan(cm.mean_iou)
                                           and np.isnan(jcm.mean_iou))
    assert str(cm) == str(jcm)
    cm.reduce_from_all_processes()                   # one process: no change
    np.testing.assert_array_equal(cm.mat, jcm.mat)
    cm.reset()
    assert int(cm.mat.sum()) == 0


def test_confusion_matrix_takes_numpy_and_matches_the_jax_example():
    cm = ConfusionMatrix(3)
    cm.update(np.asarray([0, 0, 1, 1, 2, 255]), np.asarray([0, 1, 1, 1, 0, 2]))
    acc_global, acc, iou = cm.compute()
    assert acc_global == pytest.approx(3 / 5)
    assert acc[1] == pytest.approx(1.0) and iou[1] == pytest.approx(2 / 3)


# --------------------------------------------------------------------- data

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco")
    fake.make_fake_coco(d / "port", n_train=6, n_val=3, size=64)
    jfake.make_fake_coco(d / "jax", n_train=6, n_val=3, size=64)
    return d


@pytest.mark.parametrize("maker", ["make_fake_coco", "make_structured_coco"])
def test_fake_coco_files_equal_jax(maker, tmp_path):
    getattr(fake, maker)(tmp_path / "port", n_train=3, n_val=2, size=72, seed=4)
    getattr(jfake, maker)(tmp_path / "jax", n_train=3, n_val=2, size=72, seed=4)
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 2 + 3 + 2
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def _ring(rng, h, w, kind):
    if kind == 0:
        n = int(rng.integers(3, 14))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(1, min(h, w) * 0.7, n)
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        return [float(v) for p in zip(cx + rad * np.cos(ang),
                                      cy + rad * np.sin(ang)) for v in p]
    if kind == 1:                                    # thin sliver
        y0 = float(rng.uniform(0, h))
        return [0.3, y0, w - 0.7, y0 + 0.4, w - 0.5, y0 + 1.1, 0.1, y0 + 0.6]
    if kind == 2:                                    # tiny triangle
        x0, y0 = float(rng.uniform(0, w - 4)), float(rng.uniform(0, h - 4))
        return [x0, y0, x0 + 3.3, y0 + 0.2, x0 + 0.4, y0 + 2.9]
    pts = rng.uniform([0, 0], [w, h], (6, 2))        # self-intersecting
    return [float(v) for p in pts for v in p]


def _rle_cases(rng, n):
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        mask = (rng.random((h, w)) < rng.uniform(0.05, 0.9)).astype(np.uint8)
        flat = mask.T.reshape(-1)
        edges = np.flatnonzero(np.diff(flat))
        counts = np.diff(np.concatenate([[0], edges + 1, [flat.size]])).tolist()
        if flat[0] == 1:
            counts = [0] + counts
        yield h, w, mask, counts


def _compressed(counts) -> str:
    """pycocotools' rleToString of run counts."""
    out = []
    for m, x in enumerate(counts):
        if m > 2:
            x -= counts[m - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def test_polygon_and_rle_decoders_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    for i in range(40):
        h, w = (int(v) for v in rng.integers(16, 140, 2))
        polys = [_ring(rng, h, w, i % 4)] + ([_ring(rng, h, w, 0)] if i % 5 == 0
                                              else [])
        np.testing.assert_array_equal(coco_seg.rasterize_polygons(polys, h, w),
                                      jcoco.rasterize_polygons(polys, h, w))
    for h, w, mask, counts in _rle_cases(rng, 15):
        got = coco_seg.decode_rle_counts(counts, h, w)
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(got, jcoco.decode_rle_counts(counts, h, w))
        s = _compressed(counts)
        got = coco_seg.decode_compressed_rle(s, h, w)
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(got, jcoco.decode_compressed_rle(s, h, w))


def test_merge_marks_overlaps_invalid_as_jax():
    anns = [
        {"category_id": 1, "segmentation": [[0, 0, 8, 0, 8, 8, 0, 8]]},
        {"category_id": 5, "segmentation": [[4, 4, 12, 4, 12, 12, 4, 12]]},
        {"category_id": 2, "segmentation": {"counts": [16 * 13, 16 * 3],
                                            "size": [16, 16]}},
        {"category_id": 90, "segmentation": [[0, 0, 15, 0, 15, 15]]},  # not VOC
        {"category_id": 3, "segmentation": None},
    ]
    got = coco_seg.merge_instances_to_voc(anns, 16, 16)
    np.testing.assert_array_equal(got, jcoco.merge_instances_to_voc(anns, 16, 16))
    assert got[2, 2] == coco_seg.COCO_TO_VOC[1] and got[5, 5] == 255
    assert got[0, 15] == coco_seg.COCO_TO_VOC[2] and got[14, 8] == 0
    assert coco_seg.CAT_LIST == jcoco.CAT_LIST


def test_coco_dataset_and_train_filter_equal_jax(coco_root, tmp_path):
    for split in ("train", "val"):
        ds = coco_seg.CocoVocSegmentation(coco_root / "port", split)
        jds = jcoco.CocoVocSegmentation(coco_root / "jax", split)
        assert ds.ids == jds.ids and len(ds) == (6 if split == "train" else 3)
        for i in range(len(ds)):
            (img, m), (jimg, jm) = ds[i], jds[i]
            np.testing.assert_array_equal(np.asarray(img), np.asarray(jimg))
            np.testing.assert_array_equal(m, jm)
    # the train filter: > 1000 annotated pixels in VOC categories
    root = shutil.copytree(coco_root / "port", tmp_path / "c")
    ann = root / "annotations" / "instances_train2017.json"
    data = json.loads(ann.read_text())
    data["annotations"][0]["area"] = 500.0
    data["annotations"][1]["category_id"] = 90
    ann.write_text(json.dumps(data))
    ds = coco_seg.CocoVocSegmentation(root, "train")
    assert ds.ids == jcoco.CocoVocSegmentation(root, "train").ids
    assert len(ds) == 4


def test_seg_transforms_bit_equal(coco_root):
    img, mask = coco_seg.CocoVocSegmentation(coco_root / "port", "train")[1]
    tf = seg_transforms.SegTrainTransform(base_size=72, crop_size=64)
    jtf = jst.SegTrainTransform(base_size=72, crop_size=64)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(12):            # resizes past the crop, pads below it
        (x, t), (jx, jt) = tf(img, mask, a), jtf(img, mask, b)
        assert x.dtype == np.float32 and t.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(t, jt)
    (x, t), (jx, jt) = (seg_transforms.SegEvalTransform(48)(img, mask),
                        jst.SegEvalTransform(48)(img, mask))
    assert x.shape == (3, 48, 48) and t.shape == (48, 48)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("aug", [False, True])
def test_voc_layouts_and_load_dataset_equal_jax(aug, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    if aug:        # SBD: img/ + cls_png/ + {split}.txt
        img_dir, mask_dir, sets = tmp_path / "img", tmp_path / "cls_png", tmp_path
    else:
        base = tmp_path / "VOCdevkit" / "VOC2012"
        img_dir, mask_dir = base / "JPEGImages", base / "SegmentationClass"
        sets = base / "ImageSets" / "Segmentation"
    for d in (img_dir, mask_dir, sets):
        d.mkdir(parents=True, exist_ok=True)
    names = [f"2007_{i:06d}" for i in range(3)]
    for n in names:
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8),
                        "RGB").save(img_dir / f"{n}.jpg")
        Image.fromarray(rng.integers(0, 21, (40, 48)).astype(np.uint8),
                        "L").save(mask_dir / f"{n}.png")
    (sets / "train.txt").write_text("\n".join(names[:2]))
    (sets / "val.txt").write_text(names[2])
    name = "voc_aug" if aug else "voc"
    tf = seg_transforms.SegEvalTransform(32)
    for split, n in (("train", 2), ("val", 1)):
        ds, nc = coco_seg.load_dataset(name, tmp_path, split, tf)
        jds, jnc = jcoco.load_dataset(name, tmp_path, split,
                                      jst.SegEvalTransform(32))
        assert nc == jnc == 21 and len(ds) == len(jds) == n
        for i in range(n):
            for a, b in zip(ds[i], jds[i]):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        coco_seg.load_dataset("ade20k", tmp_path, "train")


@pytest.fixture(scope="module")
def mask_build(tmp_path_factory):
    """native/maskapi.cpp built into a temporary root (no libjpeg needed)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native mask decoders cannot be "
                    "built here")
    mp = pytest.MonkeyPatch()
    mp.setenv("TAE_TPU_NATIVE", "1")
    mp.setattr(mask_native, "BUILD_ROOT", tmp_path_factory.mktemp("mask"))
    assert mask_native.available()
    yield
    mp.undo()


def test_native_mask_decoders_match_numpy(mask_build):
    """The scalar C++ maskApi against the numpy decoders, bit for bit, on
    randomized polygons (star-convex, slivers, tiny triangles,
    self-intersecting rings, multi-part unions) and both RLE forms."""
    rng = np.random.default_rng(11)
    for i in range(60):
        h, w = (int(v) for v in rng.integers(16, 140, 2))
        polys = [_ring(rng, h, w, i % 4)] + ([_ring(rng, h, w, 0)] if i % 7 == 0
                                              else [])
        np.testing.assert_array_equal(
            mask_native.rasterize_polygons(polys, h, w),
            coco_seg.rasterize_polygons(polys, h, w), err_msg=str(polys))
    for h, w, mask, counts in _rle_cases(rng, 25):
        np.testing.assert_array_equal(
            mask_native.decode_rle_counts(counts, h, w), mask)
        np.testing.assert_array_equal(
            mask_native.decode_compressed_rle(_compressed(counts), h, w), mask)
    with pytest.raises(ValueError, match="truncated"):
        mask_native.decode_compressed_rle("a", 4, 4)     # 0x31: continues


def test_native_mask_library_is_its_own_and_off_under_native_0(mask_build,
                                                              monkeypatch):
    from tae_tpu_torch.data import native

    lib = mask_native.build_library(mask_native.BUILD_ROOT)
    assert lib.name == "libtaemask.so" and lib.is_file()
    assert lib.parent.parent == mask_native.BUILD_ROOT
    assert lib != native._lib_path(mask_native.BUILD_ROOT)
    monkeypatch.setenv("TAE_TPU_NATIVE", "0")
    assert not mask_native.available()
    with pytest.raises(RuntimeError, match="not built"):
        mask_native.decode_rle_counts([1, 1], 1, 2)
