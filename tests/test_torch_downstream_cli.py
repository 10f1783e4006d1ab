"""The port's downstream drivers (``train_recognition_in19k``,
``train_recognition_in1k``, ``train_segmentation``) against the JAX
package's, on the CPU with tiny models: each ``main`` runs on the same
``.pth`` weights (the JAX models' exports: a TAE encoder, a classifier, a
segmenter) and the same fake data, with ``TAE_TPU_NATIVE=0`` on both sides
so that both decode with PIL.

The in1k driver's head swap draws the new head from each package's own
generator; the JAX side is handed the port's draw, so both train the same
weights.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.torch_export import save_torch_checkpoint
from tae_tpu.cli import _common as jcommon
from tae_tpu.cli import train_recognition_in1k as j1k
from tae_tpu.cli import train_recognition_in19k as j19k
from tae_tpu.cli import train_segmentation as jseg
from tae_tpu.models.recognition import RecognitionViT as JRecognitionViT
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.io import checkpoint_step, load_checkpoint
from tae_tpu_torch.cli import _common
from tae_tpu_torch.cli import train_recognition_in1k as r1k
from tae_tpu_torch.cli import train_recognition_in19k as r19k
from tae_tpu_torch.cli import train_segmentation as seg
from tae_tpu_torch.data.fake import (make_fake_coco, make_fake_imagefolder,
                                     make_fake_wds_shard)

ENC = "tae_patch16_vocab16_px256"
ENC_KW = dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
              decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4)
CLS = "vit_recognition_numpatches16_vocab256_base"
CLS_KW = dict(vocab_size=16, decoder_embed_dim=48, decoder_depth=2,
              decoder_num_heads=4)
SEG = "vit_segmentation_numpatches16_vocab256_base"
SEG_KW = dict(vocab_size=16, decoder_embed_dim=48, decoder_depth=4,
              decoder_num_heads=4, patch_size=16)
ENCODER = ["--encoder", ENC, "--encoder_args", json.dumps(ENC_KW),
           "--input_size", "64"]
# The same weights and batches on both sides, bf16 compute each: the
# logged losses after a few AdamW steps, relative (test_torch_cli.py's
# TRAIN_EVAL_RTOL). The int8 encoder adds the code flips of rounding ties.
TRAIN_EVAL_RTOL = 2e-2
# Segmentation mean IoU over the same val pixels: the argmax of logits
# computed in bf16 on each side flips where two classes are within a
# rounding step (measured here: 6.6e-5 apart on an IoU of 0.014)
MIOU_ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def pil_decoder():
    mp = pytest.MonkeyPatch()
    mp.setenv("TAE_TPU_NATIVE", "0")
    yield
    mp.undo()


def _export(path, name, seed, **kw):
    jm = jmodels.create(name, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    save_torch_checkpoint(path, jm, params)
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("downstream")
    make_fake_wds_shard(d / "t-000000.tar", num_samples=32, size=72,
                        num_classes=7, seed=0)
    make_fake_imagefolder(d / "train", num_classes=3, per_class=6, size=72,
                          seed=1)
    make_fake_imagefolder(d / "val", num_classes=3, per_class=3, size=72,
                          seed=2)
    make_fake_coco(d / "coco", n_train=16, n_val=3, size=64, seed=3)
    _export(d / "enc.pth", ENC, 1, **ENC_KW)
    _export(d / "cls7.pth", CLS, 2, num_classes=7, **CLS_KW)
    _export(d / "seg.pth", SEG, 3, **SEG_KW)
    return d


def _rows(path):
    return [json.loads(x) for x in path.read_text().strip().splitlines()]


def _close(a, b, rtol=TRAIN_EVAL_RTOL):
    return abs(a - b) <= rtol * abs(b)


# ------------------------------------------------------------------- in19k

def _in19k_args(parser, data, out, extra=()):
    return parser.parse_args([
        "--model", CLS, "--model_args", json.dumps(CLS_KW),
        "--model_ckpt", str(data / "cls7.pth"), "--num_classes", "7",
        *ENCODER, "--encoder_ckpt", str(data / "enc.pth"),
        "--encoder_quantization", "int8", "--encoder_equalize", "0.5",
        "--batch_size", "8", "--num_its", "7", "--save_freq", "5",
        "--log_freq", "1", "--num_workers", "0",
        "--train_data_path", str(data / "t-000000.tar"),
        "--output_dir", str(out), "--save_prefix", "r19", *extra])


@pytest.fixture(scope="module")
def in19k(data, tmp_path_factory):
    jout, out = (tmp_path_factory.mktemp(n) for n in ("j19k", "r19k"))
    j19k.main(_in19k_args(j19k.get_args_parser(), data, jout))
    r19k.main(_in19k_args(r19k.get_args_parser(), data, out,
                          ["--device", "cpu"]))
    return jout, out


def test_in19k_jsonl_matches_jax(in19k):
    jout, out = in19k
    name = f"r19_{CLS}_log.txt"
    rows, jrows = _rows(out / name), _rows(jout / name)
    assert [r["iteration"] for r in rows] == [r["iteration"] for r in jrows] == [5]
    assert set(rows[0]) == set(jrows[0]) == {"train_loss", "train_acc1",
                                             "train_acc5", "iteration"}
    assert _close(rows[0]["train_loss"], jrows[0]["train_loss"])
    assert rows[0]["train_acc5"] >= rows[0]["train_acc1"]


def test_in19k_checkpoint_holds_model_and_optimizer(in19k):
    _, out = in19k
    path = out / f"r19_{CLS}_checkpoint"
    assert checkpoint_step(path) == 5
    blob, meta = load_checkpoint(path)
    assert meta["args"]["encoder_quantization"] == "int8"
    assert blob["optimizer"] is not None
    assert tuple(blob["model"]["head.weight"].shape) == (7, 48)


def test_in19k_from_latents(data, tmp_path, capsys):
    """--latents_path: the classifier trains from an encode dump, no
    encoder built."""
    rng = np.random.default_rng(0)
    torch.save({"latents": torch.from_numpy(
                    rng.standard_normal((24, 16, 16)).astype(np.float16)),
                "targets": torch.from_numpy(rng.integers(0, 7, 24))},
               tmp_path / "z.pth")
    args = r19k.get_args_parser().parse_args([
        "--model", CLS, "--model_args", json.dumps(CLS_KW), "--num_classes",
        "7", "--latents_path", str(tmp_path / "z.pth"), "--batch_size", "8",
        "--num_its", "4", "--save_freq", "3", "--num_workers", "0",
        "--output_dir", str(tmp_path), "--device", "cpu"])
    r19k.main(args)
    text = capsys.readouterr().out
    assert "Encoder:" not in text and "decoder:" not in text
    assert [r["iteration"] for r in _rows(tmp_path / f"_{CLS}_log.txt")] == [3]


def test_in19k_nonfinite_loss_stops(data, tmp_path, monkeypatch, capsys):
    real = r19k.make_train_step

    def poisoned(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, it):
            state, metrics = step(state, batch, it)
            if it == 2:
                metrics = {**metrics, "loss": metrics["loss"] * math.nan}
            return state, metrics

        return wrapped

    monkeypatch.setattr(r19k, "make_train_step", poisoned)
    args = _in19k_args(r19k.get_args_parser(), data, tmp_path,
                       ["--device", "cpu", "--encoder_quantization", "int8"])
    with pytest.raises(SystemExit) as exc:
        r19k.main(args)
    assert exc.value.code == 1
    assert "Loss is nan, stopping training" in capsys.readouterr().out
    assert not (tmp_path / f"r19_{CLS}_checkpoint").exists()


# -------------------------------------------------------------------- in1k

def _in1k_args(parser, data, out, extra=()):
    return parser.parse_args([
        "--model", CLS, "--model_args", json.dumps(CLS_KW),
        "--model_ckpt", str(data / "cls7.pth"), "--pretrain_num_classes", "7",
        "--num_classes", "3", *ENCODER, "--encoder_ckpt", str(data / "enc.pth"),
        "--batch_size", "8", "--epochs", "1", "--log_freq", "1",
        "--num_workers", "0", "--train_data_path", str(data / "train"),
        "--val_data_path", str(data / "val"), "--output_dir", str(out),
        "--save_prefix", "ft", *extra])


@pytest.fixture(scope="module")
def in1k(data, tmp_path_factory):
    jout, out = (tmp_path_factory.mktemp(n) for n in ("j1k", "r1k"))
    # the port's head after the swap (seed 0 + 2), handed to the JAX side
    head = models.create(CLS, num_classes=7, **CLS_KW).replace_head(
        3, torch.Generator().manual_seed(2)).head
    w, b = head.weight.detach().numpy(), head.bias.detach().numpy()
    real = JRecognitionViT.replace_head

    def same_head(self, params, key, num_classes, dtype=jnp.float32):
        model, params = real(self, params, key, num_classes, dtype)
        return model, dict(params, head={"w": jnp.asarray(w.T),
                                         "b": jnp.asarray(b)})

    mp = pytest.MonkeyPatch()
    mp.setattr(JRecognitionViT, "replace_head", same_head)
    try:
        j1k.main(_in1k_args(j1k.get_args_parser(), data, jout))
    finally:
        mp.undo()
    r1k.main(_in1k_args(r1k.get_args_parser(), data, out, ["--device", "cpu"]))
    return jout, out


def test_in1k_jsonl_matches_jax(in1k):
    jout, out = in1k
    name = f"ft_{CLS}_log.txt"
    rows, jrows = _rows(out / name), _rows(jout / name)
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in jrows] == [0]
    assert set(rows[0]) == set(jrows[0]) == {
        "train_loss", "train_lr", "test_loss", "test_acc1", "test_acc5",
        "epoch"}
    assert rows[0]["train_lr"] == pytest.approx(jrows[0]["train_lr"])
    assert _close(rows[0]["train_loss"], jrows[0]["train_loss"])
    assert _close(rows[0]["test_loss"], jrows[0]["test_loss"])
    assert rows[0]["test_acc5"] == 100.0            # 3 classes: k clamps


def test_in1k_head_swap_and_best_acc1_checkpoint(in1k, data):
    from tae_tpu_torch.ckpt.io import load_params

    _, out = in1k
    row = _rows(out / f"ft_{CLS}_log.txt")[0]
    path = out / f"ft_{CLS}_checkpoint"
    assert path.exists() == (row["test_acc1"] > 0)
    if not path.exists():
        pytest.skip("no val image classified right: no best-acc1 checkpoint")
    blob, meta = load_checkpoint(path)
    assert meta["step"] == 0 and meta["best_eval_acc1"] == row["test_acc1"]
    assert tuple(blob["model"]["head.weight"].shape) == (3, 48)
    # the trunk started from the in19k .pth: the checkpoint's moved off it
    start = models.create(CLS, num_classes=7, **CLS_KW)
    load_params(data / "cls7.pth", start)
    moved = [k for k, v in start.state_dict().items() if not k.startswith(
        "head.") and not torch.equal(v, blob["model"][k])]
    assert moved


# ------------------------------------------------------------ segmentation

def _seg_args(parser, data, out, extra=()):
    return parser.parse_args([
        "--dataset", "coco", "--data_path", str(data / "coco"),
        "--model", SEG, "--model_args", json.dumps(SEG_KW), *ENCODER,
        "--encoder_ckpt", str(data / "enc.pth"), "--batch_size_per_gpu", "8",
        "--epochs", "1", "--workers", "0", "--lr", "1e-3",
        "--print_freq", "1", "--output_dir", str(out), *extra])


@pytest.fixture(scope="module")
def segmented(data, tmp_path_factory):
    jout, out = (tmp_path_factory.mktemp(n) for n in ("jseg", "seg"))
    start = ["--resume", str(data / "seg.pth")]     # the same weights
    jseg.main(_seg_args(jseg.get_args_parser(), data, jout, start))
    seg.main(_seg_args(seg.get_args_parser(), data, out,
                       ["--device", "cpu", *start]))
    return jout, out


def test_segmentation_jsonl_matches_jax(segmented):
    jout, out = segmented
    rows, jrows = _rows(out / "seg_log.txt"), _rows(jout / "seg_log.txt")
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in jrows] == [0]
    assert set(rows[0]) == set(jrows[0]) == {"train_loss", "train_lr",
                                             "mean_iou", "epoch"}
    assert _close(rows[0]["train_loss"], jrows[0]["train_loss"])
    assert abs(rows[0]["mean_iou"] - jrows[0]["mean_iou"]) <= MIOU_ATOL


def test_segmentation_checkpoint_and_resume(segmented, data, tmp_path, capsys):
    """A checkpoint every epoch with its mean IoU; --resume continues at the
    saved epoch + 1 with the saved parameters and optimizer state."""
    import shutil

    _, out = segmented
    blob, meta = load_checkpoint(out / "checkpoint")
    assert meta["step"] == 0
    assert meta["mean_iou"] == _rows(out / "seg_log.txt")[0]["mean_iou"]
    assert blob["optimizer"] is not None
    shutil.copy(out / "checkpoint", tmp_path / "ck")
    capsys.readouterr()
    seg.main(_seg_args(seg.get_args_parser(), data, tmp_path, [
        "--device", "cpu", "--resume", str(tmp_path / "ck"), "--epochs", "2"]))
    text = capsys.readouterr().out
    assert "at epoch 1" in text and "Epoch: [0]" not in text
    assert "Epoch: [1] [0]" in text
    assert [r["epoch"] for r in _rows(tmp_path / "seg_log.txt")] == [1]
    assert checkpoint_step(tmp_path / "checkpoint") == 1


def test_segmentation_head_swap(segmented, data, tmp_path, capsys):
    """--model_ckpt built at --pretrain_num_classes: the trunk loaded, both
    heads new for the dataset's 21 classes."""
    _, out = segmented
    seg.main(_seg_args(seg.get_args_parser(), data, tmp_path, [
        "--device", "cpu", "--model_ckpt", str(out / "checkpoint"),
        "--pretrain_num_classes", "21", "--epochs", "0"]))
    assert "swapped the head to 21 classes" in capsys.readouterr().out
    args = _seg_args(seg.get_args_parser(), data, tmp_path, [
        "--device", "cpu", "--model_ckpt", str(out / "checkpoint"),
        "--pretrain_num_classes", "21"])
    model = _common.build_downstream_model(args, torch.device("cpu"), 21)
    blob, _ = load_checkpoint(out / "checkpoint")
    sd = model.state_dict()
    for k, v in blob["model"].items():
        same = torch.equal(sd[k], v)
        assert same != (k.split(".")[0] in ("head", "aux_head")), k


# ------------------------------------------------------------------- flags

DRIVERS = [r19k, r1k, seg]


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("flag", ["--mesh_fsdp", "--mesh_tensor"])
def test_mesh_flags_refuse(driver, flag, tmp_path):
    args = driver.get_args_parser().parse_args(
        ["--device", "cpu", flag, "2", "--output_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="A13"):
        driver.main(args)


@pytest.mark.parametrize("driver", DRIVERS)
def test_device_flags_default_to_the_card(driver):
    args = driver.get_args_parser().parse_args([])
    assert args.device == "cuda" and args.attn_backend is None
    assert args.seed == 0 and args.mesh_fsdp == 1 and not args.remat
    with pytest.raises(SystemExit):     # the JAX backend names are not ours
        driver.get_args_parser().parse_args(["--attn_backend", "pallas"])


@pytest.mark.parametrize("jdriver,driver", [(j19k, r19k), (j1k, r1k),
                                            (jseg, seg)])
def test_flags_match_jax(jdriver, driver):
    """Flag for flag, with the JAX defaults; the device group's own
    defaults aside (--device, --attn_backend's choices)."""
    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest not in ("help", "device", "attn_backend")}

    assert flags(driver.get_args_parser()) == flags(jdriver.get_args_parser())


@pytest.mark.parametrize("mode,equalize", [(None, 0.5), ("int4", 0.0),
                                           ("fp8", 0.5)])
def test_maybe_quantize_encoder_checks_as_jax(mode, equalize):
    model = models.create(ENC, **ENC_KW)
    with pytest.raises(ValueError) as ours:
        _common.maybe_quantize_encoder(model, mode, equalize)
    with pytest.raises(ValueError) as theirs:
        jcommon.maybe_quantize_encoder({}, mode, equalize)
    assert str(ours.value) == str(theirs.value)


def test_maybe_quantize_encoder_rewrites_int8():
    from tae_tpu_torch.nn.vit import QLinear

    model = models.create(ENC, **ENC_KW)
    model.init_weights_(torch.Generator().manual_seed(0))
    assert _common.maybe_quantize_encoder(model, None) is model
    assert not any(isinstance(m, QLinear) for m in model.modules())
    _common.maybe_quantize_encoder(model, "int8", 0.5)
    assert isinstance(model.blocks[0].attn.qkv, QLinear)
    assert all(b.is_int8 for b in model.blocks)


def test_frozen_encoder_is_bf16_pruned_and_frozen(data):
    args = r19k.get_args_parser().parse_args(
        ENCODER + ["--encoder_ckpt", str(data / "enc.pth"), "--seed", "4"])
    enc = _common.frozen_encoder(args, torch.device("cpu"))
    assert enc.has_encoder and not enc.has_decoder
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in enc.parameters())
    want = models.create(ENC, **ENC_KW)
    from tae_tpu_torch.ckpt.io import load_params

    load_params(data / "enc.pth", want)
    assert torch.equal(enc.pos_embed, want.pos_embed.bfloat16())
