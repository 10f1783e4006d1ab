"""The port's drivers (``tae_tpu_torch.cli``) vs the JAX package's, on the
CPU with a tiny model: each ``main`` run on the same ``.pth`` weights (the
JAX model's, exported as ``python -m tae_tpu.cli.export_torch`` writes
them) and the same fake data, with ``TAE_TPU_NATIVE=0`` on both sides so
that both take the PIL decoder whatever native library happens to be built.
Each driver's native-decoder branch (built from ``native/taedata.cpp`` into
a temporary root) is held against its own PIL branch at the end.
"""

import io
import json
import re
import shutil
import tarfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.torch_export import save_torch_checkpoint
from tae_tpu.cli import encode as jencode
from tae_tpu.cli import evaluate as jevaluate
from tae_tpu.cli import train as jtrain
from tae_tpu_torch.cli import _common
from tae_tpu_torch.cli import encode, evaluate, train
from tae_tpu_torch.data import native
from tae_tpu_torch.data.fake import make_fake_imagefolder, make_fake_wds_shard

NAME = "tae_patch16_vocab16_px256"
TINY = dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4)
TINY_ARGS = json.dumps(TINY)
COMMON = ["--model", NAME, "--model_args", TINY_ARGS, "--input_size", "64",
          "--num_workers", "0"]
# Latents of the same weights and images, both bf16 (JAX: XLA on the CPU;
# port: the plain PyTorch versions), summed in other orders: relative
# Frobenius error. int8 adds the code flips of the ties (ROADMAP C).
LATENT_REL = {"bf16": 2e-2, "int8": 5e-2}
# Eval losses: fp32 parameters, bf16 compute on both sides, the mean of
# per-sample fp32 MSEs over the same images: relative.
EVAL_RTOL = 1e-2
# After three AdamW steps at lr 1e-4 on the same batches from the same
# weights, bf16 compute on both sides: the eval losses, relative.
TRAIN_EVAL_RTOL = 2e-2
# Native decoder against PIL, in normalized units (0.02 ~ one of 255
# levels): float resampling against PIL's fixed point, tests/test_native.py's
# bounds on smooth images (its one-box centre crop against PIL's resize then
# crop: mean 0.06).
PIX_MEAN, PIX_MAX, CROP_MEAN = 0.02, 0.25, 0.06
# What those input differences leave in the tiny model's outputs, relative:
# latents (Frobenius), eval and train losses.
NATIVE_LATENT_REL, NATIVE_LOSS_RTOL = 2e-2, 2e-3


@pytest.fixture(scope="module", autouse=True)
def pil_decoder():
    mp = pytest.MonkeyPatch()
    mp.setenv("TAE_TPU_NATIVE", "0")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_data")
    make_fake_wds_shard(d / "train-000000.tar", num_samples=20, size=72, seed=0)
    make_fake_wds_shard(d / "train-000001.tar", num_samples=20, size=72, seed=1)
    make_fake_imagefolder(d / "val", num_classes=2, per_class=5, size=72)
    jm = jmodels.create(NAME, **TINY)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(4)))
    save_torch_checkpoint(d / "w.pth", jm, params)
    return d


# ------------------------------------------------------------------- encode

def _encode_args(parser, data, out, mode, extra=()):
    quant = [] if mode == "bf16" else ["--quantization", "int8", "--equalize",
                                       "0.5"]
    return parser.parse_args(COMMON + [
        "--batch_size", "8", "--num_iters", "3", "--shard_size", "10",
        "--deterministic", "--model_ckpt", str(data / "w.pth"),
        "--data_path", str(data / "train-{000000..000001}.tar"),
        "--output_dir", str(out), "--save_prefix", "enc", *quant, *extra])


@pytest.fixture(scope="module", params=["bf16", "int8"])
def encoded(request, data, tmp_path_factory):
    mode = request.param
    jout = tmp_path_factory.mktemp(f"jenc_{mode}")
    out = tmp_path_factory.mktemp(f"enc_{mode}")
    jstats = jencode.main(_encode_args(jencode.get_args_parser(), data, jout,
                                       mode))
    stats = encode.main(_encode_args(encode.get_args_parser(), data, out, mode,
                                     ["--device", "cpu"]))
    return mode, jout, out, jstats, stats


def _index(d):
    return json.loads((d / "enc_index.json").read_text())


def test_encode_shard_layout_matches_jax(encoded):
    _, jout, out, jstats, stats = encoded
    assert sorted(p.name for p in out.iterdir()) == \
        sorted(p.name for p in jout.iterdir())
    assert _index(out) == _index(jout)
    assert [s["num_samples"] for s in _index(out)["shards"]] == [10, 10, 4]


def test_encode_index_counts_match_jax(encoded):
    _, jout, out, jstats, stats = encoded
    assert stats["num_samples"] == jstats["num_samples"] == 24
    assert _index(out)["num_samples"] == 24


def test_encode_targets_match_jax(encoded):
    _, jout, out, _, _ = encoded
    for s in _index(out)["shards"]:
        with np.load(out / s["path"]) as a, np.load(jout / s["path"]) as b:
            assert a["targets"].dtype == b["targets"].dtype == np.int32
            np.testing.assert_array_equal(a["targets"], b["targets"])


def test_encode_latents_match_jax(encoded):
    mode, jout, out, _, _ = encoded
    za, zb = [], []
    for s in _index(out)["shards"]:
        with np.load(out / s["path"]) as a, np.load(jout / s["path"]) as b:
            assert a["latents"].dtype == b["latents"].dtype == np.float16
            assert a["latents"].shape == b["latents"].shape == (
                s["num_samples"], 16, 16)
            za.append(a["latents"].astype(np.float32))
            zb.append(b["latents"].astype(np.float32))
    za, zb = np.concatenate(za), np.concatenate(zb)
    rel = float(np.linalg.norm(za - zb) / np.linalg.norm(zb))
    assert rel < LATENT_REL[mode], rel


def test_encode_latents_equal_tokenizer_encode(encoded, data):
    """The shards hold fp16 of ``Tokenizer.encode`` of the decoded batches,
    bit for bit."""
    from tae_tpu_torch.tokenizer import Tokenizer

    mode, _, out, _, _ = encoded
    tok = Tokenizer.from_checkpoint(
        NAME, str(data / "w.pth"), device="cpu", component="encoder",
        quantization=None if mode == "bf16" else "int8",
        equalize=None if mode == "bf16" else 0.5, **TINY)
    loader = encode.make_encode_loader(
        str(data / "train-{000000..000001}.tar"), 64, True, 0, 8, 0)
    z = torch.cat([tok.encode(x).to(torch.float16)
                   for x, _ in list(loader)[:3]]).numpy()
    got = np.concatenate([np.load(out / s["path"])["latents"]
                          for s in _index(out)["shards"]])
    np.testing.assert_array_equal(got, z)


def test_encode_pth_output_and_partial_batch(data, tmp_path, capsys):
    """--pth_output writes the reference's monolithic dump; a short last
    batch is padded for the encode and cut back; --device_normalize and
    --patch_layout without the native decoder take the PIL path."""
    from tae_tpu_torch.data.latents import LatentDataset

    args = encode.get_args_parser().parse_args(COMMON + [
        "--batch_size", "16", "--num_iters", "10", "--shard_size", "100",
        "--data_path", str(data / "train-000000.tar"),
        "--output_dir", str(tmp_path), "--save_prefix", "p", "--seed", "3",
        "--pth_output", str(tmp_path / "d.pth"), "--device", "cpu",
        "--device_normalize", "--patch_layout"])
    stats = encode.main(args)
    msgs = capsys.readouterr().out
    assert "decoder: pil" in msgs and "taking the PIL path" in msgs
    assert stats["num_samples"] == 20
    blob = torch.load(tmp_path / "d.pth", weights_only=True)
    assert tuple(blob["latents"].shape) == (20, 16, 16)
    assert blob["targets"].dtype == torch.int64
    assert len(LatentDataset(tmp_path / "d.pth")) == 20


# ----------------------------------------------------------------- evaluate

def _eval_args(parser, data, out, extra=()):
    return parser.parse_args(COMMON + [
        "--batch_size_per_gpu", "8", "--resume", str(data / "w.pth"),
        "--val_data_path", str(data / "val"), "--output_dir", str(out),
        "--save_prefix", "ev", "--display", *extra])


def _psnr(text: str) -> float:
    return float(re.search(r"Eval PSNR: ([0-9.]+) dB", text).group(1))


@pytest.fixture(scope="module")
def evaluated(data, tmp_path_factory):
    jout = tmp_path_factory.mktemp("jeval")
    out = tmp_path_factory.mktemp("eval")
    import contextlib
    import io

    jbuf, buf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jloss = jevaluate.main(_eval_args(jevaluate.get_args_parser(), data,
                                          jout))
    with contextlib.redirect_stdout(buf):
        loss = evaluate.main(_eval_args(evaluate.get_args_parser(), data, out,
                                        ["--device", "cpu"]))
    return jloss, loss, jbuf.getvalue(), buf.getvalue(), out


def test_evaluate_loss_matches_jax(evaluated):
    jloss, loss, _, _, _ = evaluated
    assert np.isfinite(loss)
    assert loss == pytest.approx(jloss, rel=EVAL_RTOL)


def test_evaluate_psnr_matches_jax(evaluated):
    _, _, jtext, text, _ = evaluated
    assert _psnr(text) == pytest.approx(_psnr(jtext), abs=0.05)
    assert "decoder: pil" in text and "Loaded checkpoint" in text


def test_evaluate_display_grid(evaluated):
    from PIL import Image

    *_, out = evaluated
    img = Image.open(out / "ev_sample_reconstructions.jpg")
    # 8 originals over 8 reconstructions of 64 px, 1 px padding
    assert img.size == (8 * 65 + 1, 2 * 65 + 1)


def test_evaluate_resume_changes_the_loss(data, tmp_path):
    """Without --resume the model keeps its seeded initial weights."""
    args = evaluate.get_args_parser().parse_args(COMMON + [
        "--batch_size_per_gpu", "4", "--val_data_path", str(data / "val"),
        "--output_dir", str(tmp_path), "--device", "cpu"])
    fresh = evaluate.main(args)
    assert np.isfinite(fresh)
    resumed = evaluate.main(_eval_args(evaluate.get_args_parser(), data,
                                       tmp_path, ["--device", "cpu"]))
    assert fresh != resumed


def test_evaluate_clamps_oversized_batch(data, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TAE_TPU_HBM_BYTES", str(64 << 20))
    args = evaluate.get_args_parser().parse_args(COMMON + [
        "--batch_size_per_gpu", "8192", "--val_data_path", str(data / "val"),
        "--output_dir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(evaluate.main(args))
    msg = capsys.readouterr().out
    assert "Clamping --batch_size_per_gpu 8192 ->" in msg
    assert 0 < args.batch_size_per_gpu < 8192


def test_clamp_eval_batch_refuses_a_device_too_small(monkeypatch):
    from tae_tpu_torch import models

    model = models.create(NAME, device="meta", **TINY)
    monkeypatch.setenv("TAE_TPU_HBM_BYTES", str(1 << 20))
    with pytest.raises(SystemExit, match="leave no memory"):
        _common.clamp_eval_batch(8, model, torch.device("cpu"))
    monkeypatch.setenv("TAE_TPU_HBM_BYTES", str(16 << 30))
    assert _common.clamp_eval_batch(8, model, torch.device("cpu")) == 8


# -------------------------------------------------------------------- train

def _train_args(parser, data, out, extra=()):
    return parser.parse_args(COMMON + [
        "--batch_size_per_gpu", "8", "--num_its", "6", "--save_freq", "3",
        "--log_freq", "1", "--ckpt", str(data / "w.pth"),
        "--train_data_path", str(data / "train-{000000..000001}.tar"),
        "--val_data_path", str(data / "val"), "--output_dir", str(out),
        "--save_prefix", "tr", *extra])


def _rows(out):
    return [json.loads(x) for x in
            (out / "tr_log.txt").read_text().strip().splitlines()]


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    jout = tmp_path_factory.mktemp("jtrain")
    out = tmp_path_factory.mktemp("train")
    jtrain.main(_train_args(jtrain.get_args_parser(), data, jout))
    train.main(_train_args(train.get_args_parser(), data, out,
                           ["--device", "cpu", "--display"]))
    return jout, out


def test_train_jsonl_keys_match_jax(trained):
    jout, out = trained
    rows, jrows = _rows(out), _rows(jout)
    assert [r["iteration"] for r in rows] == [r["iteration"] for r in jrows] == [3]
    assert set(rows[0]) == set(jrows[0]) >= {"train_loss", "train_lr",
                                             "train_grad_norm", "eval_loss",
                                             "iteration"}
    assert rows[0]["train_lr"] == pytest.approx(jrows[0]["train_lr"])


def test_train_eval_loss_matches_jax(trained):
    jout, out = trained
    assert _rows(out)[0]["eval_loss"] == pytest.approx(
        _rows(jout)[0]["eval_loss"], rel=TRAIN_EVAL_RTOL)
    assert _rows(out)[0]["train_loss"] == pytest.approx(
        _rows(jout)[0]["train_loss"], rel=TRAIN_EVAL_RTOL)


def test_train_checkpoints_and_grid(trained):
    from tae_tpu_torch.ckpt.io import checkpoint_step

    _, out = trained
    assert checkpoint_step(out / "tr_checkpoint_latest") == 3
    assert checkpoint_step(out / "tr_checkpoint") == 3       # improved on 100
    assert (out / "tr_reconstructions_iter_3.jpg").exists()


def test_train_resume_auto_continues_at_the_next_iteration(trained, data,
                                                          tmp_path, capsys):
    """--resume_auto takes the newer of the two checkpoints and starts at
    its step + 1 with the saved parameters and optimizer state."""
    import shutil

    from tae_tpu_torch import models
    from tae_tpu_torch.ckpt.io import load_train_state
    from tae_tpu_torch.train import adamw

    _, out = trained
    for p in out.glob("tr_checkpoint*"):
        shutil.copy(p, tmp_path / p.name)
    capsys.readouterr()
    args = _train_args(train.get_args_parser(), data, tmp_path,
                       ["--device", "cpu", "--resume_auto", "--num_its", "7"])
    args.ckpt = ""
    train.main(args)
    text = capsys.readouterr().out
    assert "Auto-resumed" in text and "at iteration 4" in text
    assert "it 3:" not in text and "it 4:" in text and "it 6:" in text
    assert [r["iteration"] for r in _rows(tmp_path)] == [6]
    model = models.create(NAME, device="cpu", trainable=True, **TINY)
    opt = adamw(weight_decay=0.05).init(model)
    _, restored, meta = load_train_state(tmp_path / "tr_checkpoint_latest",
                                         model, opt)
    assert restored and meta["step"] == 6


def test_train_nonfinite_abort(data, tmp_path, monkeypatch, capsys):
    """A NaN loss at iteration 3 stops the run with exit code 1 before the
    eval and checkpoint at iteration 5 (the reference's per-step check,
    read here one step behind)."""
    real = train.make_train_step

    def poisoned(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, it):
            state, metrics = step(state, batch, it)
            if it == 3:
                metrics = {**metrics, "loss": metrics["loss"] * float("nan")}
            return state, metrics

        return wrapped

    monkeypatch.setattr(train, "make_train_step", poisoned)
    args = _train_args(train.get_args_parser(), data, tmp_path,
                       ["--device", "cpu", "--num_its", "12", "--save_freq",
                        "5", "--log_freq", "2"])
    with pytest.raises(SystemExit) as exc:
        train.main(args)
    assert exc.value.code == 1
    text = capsys.readouterr().out
    assert "Loss is nan, stopping training" in text and "it 4" not in text
    assert not (tmp_path / "tr_checkpoint").exists()


def test_train_nonfinite_at_an_eval_stops_before_it(data, tmp_path,
                                                    monkeypatch):
    real = train.make_train_step

    def poisoned(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, it):
            state, metrics = step(state, batch, it)
            if it == 3:
                metrics = {**metrics, "loss": metrics["loss"] * float("inf")}
            return state, metrics

        return wrapped

    monkeypatch.setattr(train, "make_train_step", poisoned)
    args = _train_args(train.get_args_parser(), data, tmp_path,
                       ["--device", "cpu"])
    with pytest.raises(SystemExit):
        train.main(args)
    assert not (tmp_path / "tr_log.txt").exists()
    assert not (tmp_path / "tr_checkpoint_latest").exists()


# ------------------------------------------------------------------ flags

# In a world of 1, --mesh_fsdp 2 and --mesh_tensor 2 refuse on
# divisibility as the JAX make_mesh does.
MESH_REFUSAL = {"--mesh_fsdp": "1 devices not divisible by fsdp\\*tensor=2",
                "--mesh_tensor": "1 devices not divisible by fsdp\\*tensor=2"}


@pytest.mark.parametrize("driver", [encode, evaluate, train])
@pytest.mark.parametrize("flag", ["--mesh_fsdp", "--mesh_tensor"])
def test_mesh_flags_refuse(driver, flag, tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = driver.get_args_parser().parse_args(
        COMMON + ["--device", "cpu", flag, "2", "--output_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match=MESH_REFUSAL[flag]):
        driver.main(args)
    from tae_tpu.parallel import make_mesh as j_make_mesh

    with pytest.raises(ValueError, match=MESH_REFUSAL[flag]):
        j_make_mesh(**{flag[len("--mesh_"):]: 2}, devices=jax.devices()[:1])


@pytest.mark.parametrize("driver", [encode, evaluate, train])
def test_device_flags_default_to_the_card(driver):
    args = driver.get_args_parser().parse_args([])
    assert args.device == "cuda" and args.attn_backend is None
    assert args.seed == 0 and args.mesh_fsdp == 1 and not args.remat
    with pytest.raises(SystemExit):     # the JAX backend names are not ours
        driver.get_args_parser().parse_args(["--attn_backend", "pallas"])


def test_encode_equalize_needs_quantization(tmp_path):
    args = encode.get_args_parser().parse_args(
        COMMON + ["--device", "cpu", "--equalize", "0.5"])
    with pytest.raises(SystemExit, match="requires --quantization"):
        encode.main(args)


def test_pad_batch_matches_jax():
    from tae_tpu.cli import _common as jcommon

    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for target in (3, 5):
        a, n = _common.pad_batch(x, target)
        b, jn = jcommon.pad_batch(x, target)
        assert n == jn == 3
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ native decoder branches

def _smooth_jpeg(rng, w: int, h: int) -> bytes:
    from PIL import Image

    base = rng.integers(30, 220, (6, 8, 3)).astype(np.uint8)
    img = Image.fromarray(base, "RGB").resize((w, h), Image.Resampling.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=95)
    return buf.getvalue()


@pytest.fixture(scope="module")
def smooth(tmp_path_factory):
    """Two shards of 20 and an ImageFolder of 10 smooth JPEGs of assorted
    sizes (the native decoder's and PIL's resampling agree to a level on
    smooth images; tests/test_native.py)."""
    d = tmp_path_factory.mktemp("smooth")
    rng = np.random.default_rng(7)
    for s in range(2):
        with tarfile.open(d / f"train-{s:06d}.tar", "w") as tf:
            for i in range(20):
                w, h = (int(v) for v in rng.integers(64, 112, 2))
                for ext, blob in (("jpg", _smooth_jpeg(rng, w, h)),
                                  ("cls", str(i % 3).encode())):
                    info = tarfile.TarInfo(f"{s}{i:05d}.{ext}")
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
    for c in range(2):
        (d / "val" / f"class_{c}").mkdir(parents=True)
        for i in range(5):
            w, h = (int(v) for v in rng.integers(64, 112, 2))
            (d / "val" / f"class_{c}" / f"img_{i}.jpg").write_bytes(
                _smooth_jpeg(rng, w, h))
    return d


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """The port's libtaedata.so built into a temporary root; the decoder
    stays off (``TAE_TPU_NATIVE=0``) until a test turns it on."""
    if shutil.which("g++") is None or not Path("/usr/include/jpeglib.h").exists():
        pytest.skip("g++ or libjpeg's header is missing: the native decoder "
                    "cannot be built here")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_ROOT", tmp_path_factory.mktemp("native_build"))
    yield
    mp.undo()


def _both(monkeypatch, fn):
    """fn() with the native decoder, then with PIL."""
    monkeypatch.setenv("TAE_TPU_NATIVE", "1")
    assert native.decoder_name() == "native"
    got = fn()
    monkeypatch.setenv("TAE_TPU_NATIVE", "0")
    return got, fn()


def _close_batches(nat, pil, mean_tol):
    assert len(nat) == len(pil) > 0
    for (x, t), (y, u) in zip(nat, pil):
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(t, u)
        diff = np.abs(x - y)
        assert diff.mean() < mean_tol and diff.max() < PIX_MAX, \
            (diff.mean(), diff.max())


@pytest.mark.parametrize("deterministic", [True, False])
def test_encode_loader_native_matches_pil(native_build, smooth, monkeypatch,
                                          deterministic):
    """The encode driver's native batched decode against its per-sample PIL
    path: the same samples, crops and flips from the same seed."""
    path = str(smooth / "train-{000000..000001}.tar")
    nat, pil = _both(monkeypatch, lambda: list(encode.make_encode_loader(
        path, 64, deterministic, 3, 8, 0)))
    _close_batches(nat, pil, CROP_MEAN if deterministic else PIX_MEAN)
    assert sum(len(t) for _, t in nat) == 40


def test_train_loader_native_matches_pil(native_build, smooth, monkeypatch,
                                         capsys):
    """The train driver's native prebatched decode against its per-sample
    PIL path: the same resampled, shuffled stream, crop boxes and flips."""
    import argparse
    import itertools

    args = argparse.Namespace(
        train_data_path=str(smooth / "train-{000000..000001}.tar"),
        input_size=64, seed=2, num_workers=0, device_normalize=False)
    nat, pil = _both(monkeypatch, lambda: list(itertools.islice(
        _common.wds_train_loader(args, 8), 6)))
    _close_batches(nat, pil, PIX_MEAN)
    text = capsys.readouterr().out
    assert "native prebatched decode" in text and "PIL + np.stack" in text


def test_val_loader_native_matches_pil(native_build, smooth, monkeypatch):
    """The evaluate / train drivers' val loader: native centre crop against
    PIL's resize and crop, the same order and tail batch."""
    nat, pil = _both(monkeypatch, lambda: list(_common.imagefolder_val_loader(
        str(smooth / "val"), 64, 4)))
    _close_batches(nat, pil, CROP_MEAN)
    assert [len(t) for _, t in nat] == [4, 4, 2]


def _latents(out):
    return np.concatenate([np.load(out / s["path"])["latents"].astype(
        np.float32) for s in _index(out)["shards"]])


@pytest.mark.parametrize("flags", [[], ["--device_normalize"],
                                   ["--patch_layout"]],
                         ids=["float", "device_normalize", "patch_layout"])
def test_encode_main_native_matches_pil(native_build, smooth, data,
                                        monkeypatch, tmp_path, capsys, flags):
    """encode.main through its native branch (float, uint8 shipped and
    normalized on the device, pre-patchified rows) against its PIL branch."""
    def run():
        out = tmp_path / native.decoder_name()
        stats = encode.main(encode.get_args_parser().parse_args(COMMON + [
            "--batch_size", "8", "--num_iters", "5", "--shard_size", "16",
            "--model_ckpt", str(data / "w.pth"), "--seed", "1",
            "--data_path", str(smooth / "train-{000000..000001}.tar"),
            "--output_dir", str(out), "--save_prefix", "enc",
            "--device", "cpu", *flags]))
        return out, stats, capsys.readouterr().out

    (nout, nstats, ntext), (pout, pstats, _) = _both(monkeypatch, run)
    assert "decoder: native" in ntext and "PIL path" not in ntext
    assert nstats["num_samples"] == pstats["num_samples"] == 40
    assert _index(nout) == _index(pout)
    for s in _index(nout)["shards"]:
        with np.load(nout / s["path"]) as a, np.load(pout / s["path"]) as b:
            np.testing.assert_array_equal(a["targets"], b["targets"])
    za, zb = _latents(nout), _latents(pout)
    rel = float(np.linalg.norm(za - zb) / np.linalg.norm(zb))
    assert rel < NATIVE_LATENT_REL, rel


def test_evaluate_main_native_matches_pil(native_build, smooth, data,
                                          monkeypatch, tmp_path, capsys):
    def run():
        loss = evaluate.main(_eval_args(
            evaluate.get_args_parser(), data, tmp_path,
            ["--device", "cpu", "--val_data_path", str(smooth / "val")]))
        return loss, capsys.readouterr().out

    (nloss, ntext), (ploss, _) = _both(monkeypatch, run)
    assert "decoder: native" in ntext and np.isfinite(nloss)
    assert nloss == pytest.approx(ploss, rel=NATIVE_LOSS_RTOL)


@pytest.mark.parametrize("flags", [[], ["--device_normalize"]],
                         ids=["float", "device_normalize"])
def test_train_main_native_matches_pil(native_build, smooth, data,
                                       monkeypatch, tmp_path, capsys, flags):
    """train.main through the native prebatched loader (float, or uint8
    normalized on the device) against the PIL per-sample loader: the same
    batches, so the same losses to the decoders' difference."""
    def run():
        out = tmp_path / native.decoder_name()
        train.main(_train_args(train.get_args_parser(), data, out, [
            "--device", "cpu", "--num_its", "4", "--train_data_path",
            str(smooth / "train-{000000..000001}.tar"), "--val_data_path",
            str(smooth / "val"), *flags]))
        return _rows(out), capsys.readouterr().out

    (nrows, ntext), (prows, _) = _both(monkeypatch, run)
    assert "decoder: native" in ntext and "native prebatched" in ntext
    assert [r["iteration"] for r in nrows] == [r["iteration"] for r in prows] == [3]
    for key in ("train_loss", "eval_loss"):
        assert nrows[0][key] == pytest.approx(prows[0][key],
                                              rel=NATIVE_LOSS_RTOL), key
