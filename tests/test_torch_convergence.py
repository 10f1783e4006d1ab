"""The convergence path of the port (``tae_tpu_torch/scripts``) against the
repo's scripts, on the CPU with tiny models:

- ``quant_accuracy``'s six serving modes against ``scripts/quant_accuracy.py``'s
  ``make_steps`` on the JAX ``Tokenizer``, from the same exported weights and
  the same images, through the same forward;
- ``convergence.run``: a run cut into chunks (one of them failing once and
  run again from the last checkpoint) against the same run unbroken, losses
  and the final training state bit for bit;
- ``convergence.train_argv`` against ``scripts/convergence_run.sh``'s flags,
  read from that file as text;
- ``convergence_report``'s parsers against ``scripts/convergence_report.py``'s
  on a log the port's ``cli.train`` wrote.
"""

import contextlib
import importlib.util
import io
import json
import shlex
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.torch_export import save_torch_checkpoint
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu_torch.cli import train
from tae_tpu_torch.data import fake, native
from tae_tpu_torch.data.transforms import normalize
from tae_tpu_torch.scripts import convergence, convergence_report, quant_accuracy

REPO = Path(__file__).resolve().parents[1]
NAME = "tae_patch16_vocab16_px256"
# width 256: K / 2 a multiple of 128, so the int4 modes pack the blocks'
# linears (a narrower block falls back to int8)
QUANT_TINY = dict(img_size=64, embed_dim=256, depth=2, num_heads=4,
                  decoder_embed_dim=256, decoder_depth=2, decoder_num_heads=4)
TRAIN_TINY = dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
                  decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4)
# The same weights and images through both packages, bf16 on both sides and
# the same forward (the JAX script's: forward_encoder / forward_decoder with
# the exact softmax; JAX: XLA on the CPU, the port: the kernels' plain
# versions), summed in other orders. The reconstruction MSE relative
# (MSE_RTOL); each quantized mode's change of MSE against its own bf16 row
# within MSE_DELTA_PCT percentage points of the JAX script's (the changes
# are 0.01-0.2 % at this seeded init; a wrong scale or packing moves the MSE
# by whole percents); its latent relative error within REL_ERR_RTOL of the
# JAX script's, relative: the two plain int8 paths quantize the MLP's hidden
# activations differently (the JAX package's XLA path each linear's whole
# input row, the port's the kernels' way, one scale a row over each block of
# block_h columns), which moves the error by a few percent.
MSE_RTOL = {"bf16": 2e-2, "int8": 4e-2, "int4": 4e-2}
MSE_DELTA_PCT = 0.1
REL_ERR_RTOL = 0.1


def _script(name: str):
    """A module of the repo's ``scripts/``, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"repo_scripts_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------- quant_accuracy

@pytest.fixture(scope="module")
def quant_results(tmp_path_factory):
    """Both scripts' per-mode metrics on 2 eval batches of 4 structured
    images (and 1 calibration batch), from one exported JAX init."""
    d = tmp_path_factory.mktemp("quant")
    jm = jmodels.create(NAME, **QUANT_TINY)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(7)))
    save_torch_checkpoint(d / "w.pth", jm, params)
    rng = np.random.default_rng(3)
    imgs = np.stack([normalize(fake._structured_image(rng, 64)
                               .transpose(2, 0, 1).astype(np.float32) / 255.0)
                     for _ in range(12)])
    batches = [imgs[i:i + 4].astype(np.float32) for i in range(0, 12, 4)]
    evals, calib = batches[:2], batches[2:]

    mp = pytest.MonkeyPatch()
    # the port's int4 MLP hidden block (the JAX package defaults to 512)
    mp.setenv("TAE_TPU_INT4_MLP_BH", "256")
    try:
        jscript = _script("quant_accuracy")
        theirs, ref = {}, []
        for name, kw in quant_accuracy.MODES.items():
            kw = dict(kw)
            if kw.pop("calib", False):
                kw["calib_images"] = calib
            tok = JTokenizer.from_checkpoint(NAME, str(d / "w.pth"), **kw,
                                             **QUANT_TINY)
            ref_step, step = jscript.make_steps(tok)
            rels, mses = [], []
            for i, x in enumerate(evals):
                if name == "bf16":
                    z32, mse = ref_step(tok.params, x)
                    ref.append(z32)
                else:
                    rel, mse = step(tok.params, x, ref[i])
                    rels.append(float(rel))
                mses.append(float(mse))
            theirs[name] = {"rel_err": float(np.mean(rels)) if rels else 0.0,
                            "mse": float(np.mean(mses))}
    finally:
        mp.undo()
    ours = quant_accuracy.evaluate_modes(NAME, str(d / "w.pth"), evals, calib,
                                         list(quant_accuracy.MODES), "cpu",
                                         **QUANT_TINY)
    return ours, theirs


@pytest.mark.parametrize("mode", list(quant_accuracy.MODES))
def test_quant_accuracy_matches_the_jax_script(quant_results, mode):
    ours, theirs = quant_results
    assert list(ours) == list(quant_accuracy.MODES)    # bf16 first
    got, want = ours[mode], theirs[mode]
    assert got["mse"] == pytest.approx(want["mse"],
                                       rel=MSE_RTOL[mode.split("+")[0]])
    if mode == "bf16":
        assert got["rel_err"] == want["rel_err"] == 0.0
        assert got["mse_delta_pct"] == 0.0
    else:
        assert 0.0 < got["rel_err"] < 0.2
        assert got["rel_err"] == pytest.approx(want["rel_err"],
                                               rel=REL_ERR_RTOL)
        want_delta = 100.0 * (want["mse"] - theirs["bf16"]["mse"]) / \
            theirs["bf16"]["mse"]
        assert abs(got["mse_delta_pct"] - want_delta) <= MSE_DELTA_PCT


def test_quant_accuracy_main_prints_the_table_and_json(tmp_path, capsys):
    """The command line: a checkpoint and a val ImageFolder in, the markdown
    table and the JSON line (also to ``--out_json``) out, bf16 first."""
    from tae_tpu_torch import models
    from tae_tpu_torch.ckpt.io import save_checkpoint

    tiny = dict(QUANT_TINY, depth=1, decoder_depth=1)
    model = models.create(NAME, device="cpu", **tiny)
    model.init_weights_(torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "ck", model, step=3)
    fake.make_structured_imagefolder(tmp_path / "val", num_images=6, size=72,
                                     seed=1)
    quant_accuracy.main([
        "--model", NAME, "--ckpt", str(tmp_path / "ck"), "--val_data_path",
        str(tmp_path / "val"), "--input_size", "64", "--batch_size", "2",
        "--num_batches", "2", "--calib_batches", "1", "--modes",
        "int8,int4+eq+calib", "--model_args", json.dumps(tiny), "--device",
        "cpu", "--out_json", str(tmp_path / "q.json")])
    out = capsys.readouterr().out
    assert "| mode | latent rel err vs bf16 | recon MSE | MSE vs bf16 |" in out
    line = json.loads((tmp_path / "q.json").read_text())
    assert line["images"] == 4 and line["checkpoint_step"] == 3
    assert "step 3" in out
    assert list(line["results"]) == ["bf16", "int8", "int4+eq+calib"]
    assert json.dumps(line) in out


# --------------------------------------------------------------------- run

def _tiny_run_argv(root: Path, num_its: int) -> list[str]:
    return convergence.with_flags(
        convergence.train_argv(root, num_its, save_freq=3, shards=2),
        batch_size_per_gpu=2, accum_iter=2, num_workers=0, log_freq=1,
        input_size=64, device="cpu", model_args=json.dumps(TRAIN_TINY))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv")
    convergence.fixture(root, shards=2, samples=6, size=72, val_images=6,
                        workers=1)
    return root


def _recording(monkeypatch, losses: dict, fail_at=None):
    """cli.train's steps, each iteration's loss recorded (a rerun of an
    iteration must give the same bits); ``fail_at``: raise once, there."""
    real = train.make_train_step
    failed = []

    def make(*a, **kw):
        step = real(*a, **kw)

        def counted(state, batch, it):
            if it == fail_at and not failed:
                failed.append(it)
                raise RuntimeError("a chunk dies mid-way")
            state, metrics = step(state, batch, it)
            loss = float(metrics["loss"])
            assert losses.setdefault(it, loss) == loss
            return state, metrics

        return counted

    monkeypatch.setattr(train, "make_train_step", make)
    return failed


@pytest.fixture(params=["pil", "native"])
def decoder(request, monkeypatch):
    if request.param == "native" and not native.available():
        pytest.skip("the native decoder does not build here")
    monkeypatch.setenv("TAE_TPU_NATIVE", "0" if request.param == "pil"
                       else "1")
    return request.param


def test_chunked_run_equals_the_unbroken_run(corpus, tmp_path, monkeypatch,
                                             decoder):
    """Iterations 0-6 in one call, against 0-3 and 4-6 through the chunk
    loop with the second chunk dying at iteration 5 and run again from the
    checkpoint at 3: the same loss at every iteration and the same final
    parameters, optimizer state and JSONL rows, bit for bit."""
    from tae_tpu_torch.ckpt.io import checkpoint_step

    whole, cut = tmp_path / "whole", tmp_path / "cut"
    runs = {}
    for out, ends, fail_at in ((whole, [7], None), (cut, [4, 7], 5)):
        losses: dict = {}
        failed = _recording(monkeypatch, losses, fail_at)
        argv = convergence.with_flags(_tiny_run_argv(corpus, 7),
                                      output_dir=out)
        records = convergence.run(argv, ends, in_process=True)
        runs[out] = losses
        assert [r["end"] for r in records] == ends
        assert failed == ([] if fail_at is None else [fail_at])
        if fail_at is not None:
            assert [r["attempts"] for r in records] == [1, 2]
    assert sorted(runs[whole]) == list(range(7))
    assert runs[cut] == runs[whole]
    for d in (whole, cut):
        assert checkpoint_step(d / "conv_checkpoint_latest") == 6
    got = torch.load(cut / "conv_checkpoint_latest", weights_only=True)
    want = torch.load(whole / "conv_checkpoint_latest", weights_only=True)
    flat_got = _flat(got["model"]) + _flat(got["optimizer"])
    flat_want = _flat(want["model"]) + _flat(want["optimizer"])
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (k, a), (_, b) in zip(flat_got, flat_want):
        assert torch.equal(a, b), k
    assert (cut / "conv_log.txt").read_text() == \
        (whole / "conv_log.txt").read_text()
    rows = [json.loads(x) for x in (cut / "conv_chunks.jsonl").read_text()
            .splitlines()]
    assert [r["end"] for r in rows] == [4, 7]


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str)
                for x in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{prefix}/{i}")]
    return [(prefix, torch.tensor(float(tree)))] if isinstance(
        tree, (int, float)) else []


def test_run_gives_up_after_its_attempts(corpus, tmp_path, monkeypatch):
    """A chunk that fails every attempt ends the run, after
    ``ATTEMPTS`` tries."""
    tries = []

    def dies(argv):
        tries.append(argv)
        raise RuntimeError("out of memory")

    monkeypatch.setattr(convergence, "_train_in_process", dies)
    argv = convergence.with_flags(_tiny_run_argv(corpus, 7),
                                  output_dir=tmp_path)
    with pytest.raises(SystemExit, match="failed 3 times"):
        convergence.run(argv, [4, 7], in_process=True)
    assert len(tries) == convergence.ATTEMPTS == 3
    assert all(a[a.index("--num_its") + 1] == "4" for a in tries)


# ------------------------------------------------------------------- flags

def _launcher_flags() -> list[str]:
    """cli.train's flags in ``scripts/convergence_run.sh``, its positional
    defaults filled in."""
    text = (REPO / "scripts" / "convergence_run.sh").read_text()
    cmd = text[text.index("exec python -m tae_tpu.cli.train"):]
    cmd = cmd.replace("\\\n", " ").replace('"${1:-5001}"', "5001")
    cmd = cmd.replace('"${2:-500}"', "500")
    return shlex.split(cmd)[4:]


def _pairs(argv: list[str]) -> list[tuple[str, str | None]]:
    out = []
    for i, a in enumerate(argv):
        if a.startswith("--"):
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            out.append((a, None if nxt is None or nxt.startswith("--")
                        else nxt))
    return out


def test_run_passes_the_launchers_flags():
    """The same flags in the same order with the same values; the paths
    under the run's own root, their last parts the launcher's."""
    paths = {"--train_data_path", "--val_data_path", "--output_dir"}
    root = Path(".convergence/torch")
    ours = _pairs(convergence.train_argv(root))
    theirs = _pairs(_launcher_flags())
    assert [f for f, _ in ours] == [f for f, _ in theirs]
    for (f, v), (_, w) in zip(ours, theirs):
        if f in paths:      # the same path under each run's root
            assert str(Path(v).relative_to(root)) == \
                w.split(".convergence/", 1)[1]
        else:
            assert v == w, f
    assert dict(ours)["--num_its"] == str(convergence.NUM_ITS)


@pytest.mark.parametrize("num_its, chunk_its, ends", [
    (5001, 1000, [1001, 2001, 3001, 4001, 5001]),
    (5001, 0, [5001]),
    (301, 150, [151, 301]),
    (7, 3, [4, 7]),
])
def test_chunks_end_just_past_a_save_point(num_its, chunk_its, ends):
    """``convergence_chunks.sh``'s chunk list: each chunk's last iteration
    a multiple of the chunk length (an eval and a checkpoint)."""
    assert convergence.chunk_ends(num_its, chunk_its) == ends
    assert all((e - 1) % max(chunk_its, 1) == 0 or e == num_its for e in ends)


# ------------------------------------------------------------------ report

@pytest.fixture(scope="module")
def train_logs(corpus, tmp_path_factory):
    """A run of the port's cli.train (iterations 0-6, evals at 3 and 6):
    its JSONL log and its standard output."""
    out = tmp_path_factory.mktemp("report")
    argv = convergence.with_flags(_tiny_run_argv(corpus, 7), output_dir=out)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        convergence.run(argv, [7], in_process=True)
    (out / "run.log").write_text(buf.getvalue())
    return out / "conv_log.txt", out / "run.log"


def test_report_parses_what_the_jax_script_parses(train_logs):
    jreport = _script("convergence_report")
    log, stdout = train_logs
    rows = convergence_report.parse_jsonl(str(log))
    assert rows == jreport.parse_jsonl(str(log))
    assert [r["iteration"] for r in rows] == [3, 6]
    points = convergence_report.parse_stdout(str(stdout))
    assert points == jreport.parse_stdout(str(stdout))
    assert [p[0] for p in points] == list(range(7))


def test_report_tables_put_the_jax_run_beside(train_logs, tmp_path):
    log, stdout = train_logs
    q = {"images": 8, "results": {
        "bf16": {"rel_err": 0.0, "mse": 0.004, "mse_delta_pct": 0.0},
        "int8": {"rel_err": 0.05, "mse": 0.005, "mse_delta_pct": 25.0}}}
    (tmp_path / "q.json").write_text(json.dumps(q) + "\n")
    text = convergence_report.main([
        "--run_log", str(log), "--stdout_log", str(stdout), "--quant_json",
        str(tmp_path / "q.json"), "--every", "3", "--out_md",
        str(tmp_path / "r.md")])
    assert (tmp_path / "r.md").read_text() == text + "\n"
    rows = convergence_report.parse_jsonl(str(log))
    assert f"| 3 | {rows[0]['train_loss']:.4f} | {rows[0]['eval_loss']:.4f}" \
        " | — | — |" in text
    assert "| 5000 | — | — | 0.0038 | 0.0044 |" in text
    assert "| int8 | 0.05 | 0.00500 | +25.00% | 0.068 | 0.01106 |" in text
    assert "| 6 |" in text.split("Train loss every 3")[1]


# ------------------------------------------------------------ train stream

STREAM = dict(jitter_scale=(0.2, 1.0), jitter_ratio=(3 / 4, 4 / 3), seed=3,
              process_index=0, process_count=1)


def _shards(corpus) -> str:
    return str(corpus / "data" / "train-{000000..000001}.tar")


def test_pil_batched_stream_equals_the_per_sample_stream(corpus):
    """The threaded PIL path: float batches bit-equal to the per-sample
    path's samples in order, uint8 batches the same crops (normalized on
    the device within float rounding), ``skip`` the stream's later
    samples."""
    from tae_tpu_torch.cli import _common
    from tae_tpu_torch.data.transforms import device_normalize

    per = _common._wds_train_iter(_shards(corpus), 64, **STREAM,
                                  worker_id=0, num_workers=1)
    want = [next(per) for _ in range(13)]
    f32 = _common._wds_train_iter_pil_batched(
        _shards(corpus), 64, **STREAM, batch_size=5, u8=False, worker_id=0,
        num_workers=1)
    got = [next(f32) for _ in range(2)]
    assert got[0][0].dtype == np.float32 and got[0][1].dtype == np.int32
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]),
                                  np.stack([w[0] for w in want[:10]]))
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                  [w[1] for w in want[:10]])
    u8 = _common._wds_train_iter_pil_batched(
        _shards(corpus), 64, **STREAM, batch_size=5, u8=True, worker_id=0,
        num_workers=1, skip=3)
    x, cls = next(u8)
    assert x.dtype == np.uint8 and x.shape == (5, 3, 64, 64)
    np.testing.assert_allclose(device_normalize(torch.from_numpy(x)).numpy(),
                               np.stack([w[0] for w in want[3:8]]), atol=1e-5)
    np.testing.assert_array_equal(cls, [w[1] for w in want[3:8]])


@pytest.mark.parametrize("workers", [0, 1])
def test_loader_skip_starts_where_the_saved_run_stopped(corpus, decoder,
                                                        workers):
    """``wds_train_loader(skip_batches=k)``'s first batch is batch k of the
    unskipped stream (the driver's loader, the decoder of the run)."""
    from types import SimpleNamespace

    from tae_tpu_torch.cli import _common

    args = SimpleNamespace(train_data_path=_shards(corpus), input_size=64,
                           num_workers=workers, seed=2,
                           device_normalize=True)
    whole = iter(_common.wds_train_loader(args, 4))
    want = [next(whole) for _ in range(4)][3]
    got = next(iter(_common.wds_train_loader(args, 4, skip_batches=3)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("row_max, exact", [(20.0, True), (100.0, False)])
def test_serving_softmax_is_exact_only_inside_its_clamp(row_max, exact):
    """The serving softmax (scores clamped to [-60, 45], no row maximum;
    the JAX package's ``_serving_softmax``) against the exact one, with
    one query row whose largest scaled score is ``row_max``: equal below
    the ceiling, far apart above it, as the trained tokenizer's decoder
    blocks show (``bench/serving_probe.py``: row maxima up to 173)."""
    from tae_tpu_torch.ops.cuda.flash_attention import (
        SOFTMAX_CLIP, fused_qkv_attention_reference)

    gen = torch.Generator().manual_seed(0)
    b, n, h, dh = 1, 8, 1, 64
    q = torch.zeros(b, n, h, dh)
    k = torch.randn(b, n, h, dh, generator=gen) * 0.1
    v = torch.randn(b, n, h, dh, generator=gen)
    # row 0's scores: row_max on key 0, row_max - 2 on key 1, ~0 elsewhere
    k[0, 0, 0] = k[0, 1, 0] = 0.0
    k[0, 0, 0, 0], k[0, 1, 0, 0] = row_max, row_max - 2.0
    q[0, 0, 0, 0] = dh ** 0.5
    qkv = torch.cat([q, k, v], dim=2).reshape(b, n, 3 * h * dh)
    got = fused_qkv_attention_reference(qkv, h, serving=True)
    want = fused_qkv_attention_reference(qkv, h, serving=False)
    assert (row_max <= SOFTMAX_CLIP[1]) == exact
    err = float((got[0, 0] - want[0, 0]).norm() / want[0, 0].norm())
    if exact:
        assert err < 1e-5
    else:   # both keys clamped to 45: weights 1/2, 1/2 where exact gives
        assert err > 0.1    # 0.88, 0.12
    torch.testing.assert_close(got[0, 1:], want[0, 1:], rtol=1e-5,
                               atol=1e-6)
