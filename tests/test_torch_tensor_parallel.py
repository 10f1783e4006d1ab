"""The ``tensor`` axis of the port's mesh (``tae_tpu_torch.parallel``:
each block's heads and MLP split over ``tensor``, FSDP2 over ``data`` ×
``fsdp``) against the JAX package's ``tae_tpu.parallel`` and against one
process, on the CPU.

Several processes run through ``tae_tpu_torch.parallel.spawn`` (one
thread each, a ``FileStore`` under ``tmp_path``, killed at a timeout); the
rank bodies are in ``tests/torch_parallel_workers.py``. The drivers take
the PIL decoder (``TAE_TPU_NATIVE=0``) on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tae_tpu import models as jmodels
from tae_tpu.models.tae import TAE as JTAE
from tae_tpu.models.tae import TAEConfig as JTAEConfig
from tae_tpu.parallel import make_mesh as j_make_mesh
from tae_tpu.parallel import param_shardings, shard_params
from tae_tpu.parallel.sharding import batch_sharding
from tae_tpu.train import TrainState as JTrainState
from tae_tpu.train import adamw as j_adamw
from tae_tpu.train import make_train_step as j_make_train_step
from tae_tpu.train import step_lr as j_step_lr
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import state_dict_from_jax
from tae_tpu_torch.ckpt.io import load_checkpoint
from tae_tpu_torch.cli import encode, evaluate, train, train_segmentation
from tae_tpu_torch.data.fake import (make_fake_coco, make_fake_imagefolder,
                                     make_fake_wds_shard)
from tae_tpu_torch.parallel import AXES, param_placements, spawn
from tae_tpu_torch.parallel.mesh import mesh_sizes
from tae_tpu_torch.parallel.tensor import regroup

TIMEOUT = 180
# one process against a split: fp32 sums in another order (the partial
# products of proj / fc2 summed over the tensor ranks)
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
# parameters after AdamW steps at lr 1e-3, held to a share of the step
# size (tests/test_torch_parallel.py says why)
LR = 1e-3
PARAM_ATOL = 0.05 * LR
# A qk_norm block's k_norm bias adds one vector to every key of a head,
# which the softmax ignores: its exact gradient is 0, and AdamW moves it by
# up to one step size a step whichever way the rounding noise points
# (measured here: 1.0e-4 apart after two steps). Held to that bound.
ZERO_GRAD_ATOL = 2 * 2 * LR
# the drivers on two ranks of a (1, 1, 2) mesh against one process, bf16
# compute each: the split rounds each partial product of proj and fc2 to
# bf16 before their fp32 sum, where one process rounds the whole product
# once. Held to one bf16 rounding step, relative (measured here: train loss
# 5.9e-5, gradient norm 9.5e-4, eval loss 2.3e-5, segmentation loss
# 7.4e-6), and the fp16 latents to four bf16 steps at |z| <= 8 (measured
# 3.1e-2: two steps at |z| = 4). The segmentation mean IoU as
# test_torch_downstream_cli.py's MIOU_ATOL (measured 5.8e-5).
BF16_RTOL = 2.0 ** -8
MIOU_ATOL = 2e-3
BF16_LATENT_ATOL = 6.25e-2


def _run(fn, world, tmp_path, *args, store="store"):
    return spawn.run(fn, world, *args, store=str(tmp_path / store),
                     timeout=TIMEOUT)


def _assert_params_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        atol = ZERO_GRAD_ATOL if name.endswith("k_norm.bias") else PARAM_ATOL
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    """The tiny TAE's parameters from JAX's init, in both layouts, and a
    global batch of 8 images."""
    jm = JTAE(JTAEConfig(**workers.TINY))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, jm.cfg).items()}
    images = np.random.default_rng(3).standard_normal(
        (8, 3, 32, 32)).astype(np.float32)
    return jm, params, sd, images


# --------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n,data,fsdp,tensor", [
    (2, -1, 1, 2), (4, -1, 2, 2), (4, 1, 1, 4), (8, -1, 2, 2), (8, 1, 4, 2),
    (8, 2, 1, 4), (4, -1, 1, 3), (8, 2, 2, 4), (1, -1, 1, 2)])
def test_make_mesh_counts_match_jax_with_tensor(n, data, fsdp, tensor):
    """The axis sizes, and the errors, of the JAX ``make_mesh`` with a
    tensor axis (the JAX side on n virtual CPU devices)."""
    try:
        want = j_make_mesh(data=data, fsdp=fsdp, tensor=tensor,
                           devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{str(e)}$".replace(
                "*", r"\*")):
            mesh_sizes(n, data, fsdp, tensor)
        return
    assert dict(zip(AXES, mesh_sizes(n, data, fsdp, tensor))) == dict(
        want.shape)


# ------------------------------------------------------------ placement

@pytest.mark.parametrize("sizes", [(1, 4, 2), (2, 2, 2)])
@pytest.mark.parametrize("name", [
    "tae_patch32_vocab1024_px256", "tae_patch64_vocab4096_px256",
    "tae_patch128_vocab4096_px256"])
def test_param_bytes_match_jax_shardings_with_tensor(name, sizes):
    """Per-rank parameter bytes of the big configs (built on the meta
    device) against ``param_shardings``' per-device bytes on the same
    8-device mesh. The split cuts the same matrices as the JAX rules (qkv /
    fc1 rows, proj / fc2 columns); FSDP2 also shards the 1-D leaves the
    JAX rules replicate: the two agree within 1%."""
    model = models.create(name, device="meta")
    placed = param_placements(model, dict(zip(AXES, sizes)))
    ours = sum(p.local_bytes(4) for p in placed.values())
    split = [n for n, p in placed.items() if p.tensor_dim is not None]
    assert len(split) == 6 * (model.cfg.depth + model.cfg.decoder_depth)

    jm = jmodels.create(name)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    leaves = jax.tree.leaves(shapes)
    mesh = j_make_mesh(*sizes)
    theirs = sum(int(np.prod(s.shard_shape(l.shape))) * 4 for l, s in
                 zip(leaves, jax.tree.leaves(param_shardings(shapes, mesh))))
    assert 0.99 <= ours / theirs <= 1.01, (ours, theirs)


def test_four_heads_over_tensor_eight_stay_whole():
    """4 heads over tensor = 8: each block stays whole (no rank would hold
    a head); the JAX rule, which tests qkv's 3·D = 192, splits it. The
    embeddings and heads are never split."""
    model = workers.tiny_model()
    placed = param_placements(model, {"tensor": 8})
    assert all(p.tensor_dim is None for p in placed.values())
    assert placed["blocks.0.attn.qkv.weight"].local_shape == (192, 64)
    mesh = j_make_mesh(1, 1, 8)
    jm = JTAE(JTAEConfig(**workers.TINY))
    spec = param_shardings(jm.init(jax.random.key(0)),
                           mesh)["encoder"]["blocks"]["attn"]["qkv"]["w"].spec
    assert spec[-1] == "tensor"
    # at tensor = 2 the same blocks split: 2 heads a rank
    placed = param_placements(model, {"tensor": 2})
    assert placed["blocks.0.attn.qkv.weight"].local_shape == (96, 64)
    assert placed["blocks.0.attn.proj.weight"].local_shape == (64, 32)
    assert placed["blocks.0.attn.proj.bias"].tensor_dim is None
    assert placed["dict_proj.weight"].tensor_dim is None


def test_regroup_round_trip():
    w = torch.arange(4 * 3 * 6 * 5.0).reshape(72, 5)
    grouped = regroup(w, 4, True)
    # rank r's rows: q, k and v of its heads
    r1 = grouped[18:36]
    torch.testing.assert_close(r1, torch.cat([w[6:12], w[30:36], w[54:60]]))
    torch.testing.assert_close(regroup(grouped, 4, False), w, rtol=0, atol=0)


# ------------------------------------------------------- one (1, 1, 2) run

@pytest.fixture(scope="module")
def split_run(tiny, tmp_path_factory):
    _, _, sd, images = tiny
    tmp = tmp_path_factory.mktemp("split")
    rows = np.random.default_rng(4).standard_normal(
        (4, 16, 64)).astype(np.float32)
    path = tmp / "split.pt"
    out = spawn.run(workers.split_checks, 2, sd, images, rows, str(path),
                    store=str(tmp / "store"), timeout=TIMEOUT)
    return out, rows, path


def test_split_holds_each_ranks_heads(split_run, tiny):
    """Rank r holds the q, k and v rows of heads 2r and 2r + 1 and the
    proj columns they feed; its attention runs on 2 heads."""
    _, _, sd, _ = tiny
    out, _, _ = split_run
    w, proj = sd["blocks.0.attn.qkv.weight"], sd["blocks.0.attn.proj.weight"]
    for rank, r in enumerate(out):
        assert r["heads"] == 2
        rows = np.concatenate([w[i * 64 + rank * 32:i * 64 + rank * 32 + 32]
                               for i in range(3)])
        np.testing.assert_array_equal(r["qkv"], rows)
        np.testing.assert_array_equal(r["proj"],
                                      proj[:, rank * 32:rank * 32 + 32])


def test_split_state_dict_is_the_unsplit_models(split_run, tiny):
    """The checkpoint of the split model holds the unsplit model's
    state_dict, key for key and bit for bit (the reference's layout)."""
    _, _, sd, _ = tiny
    _, _, path = split_run
    blob, _ = load_checkpoint(path)
    assert set(blob["model"]) == set(sd)
    for name, want in sd.items():
        np.testing.assert_array_equal(blob["model"][name].numpy(), want,
                                      err_msg=name)


def test_qk_norm_stack_split_matches_one_process(split_run):
    out, rows, _ = split_run
    losses, norms, params = workers.qk_norm_steps(None, rows, 2)
    got = out[0]["qk_norm"]
    np.testing.assert_allclose(got[0], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1], norms, rtol=NORM_RTOL)
    assert got[0][1] < got[0][0]
    _assert_params_close(got[2], params)


def test_three_heads_stay_whole_and_match_one_process(split_run, tiny):
    """3 heads over tensor = 2: the blocks stay whole on both ranks and
    train as one process does."""
    _, _, _, images = tiny
    out, _, _ = split_run
    want = workers.train_steps(None, None, images, 2,
                               cfg_kw=workers.THREE_HEADS)
    for r in out:
        np.testing.assert_allclose(r["fallback"][0], want[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["fallback"][1], want[1], rtol=NORM_RTOL)
        _assert_params_close(r["fallback"][2], want[2])


def test_split_tokenizer_matches_one_process(split_run, tiny):
    """``Tokenizer.from_checkpoint(mesh=)`` on (1, 1, 2) splits the fp32
    model; both ranks' latents are one process's."""
    _, _, _, images = tiny
    out, _, _ = split_run
    want = workers.encode_tiny(None, images)
    for r in out:
        np.testing.assert_allclose(r["latents"], want, rtol=0, atol=1e-5)


# ------------------------------------------------------------ train steps

@pytest.mark.parametrize("sizes", [(1, 1, 2), (2, 1, 2), (1, 2, 2)])
def test_tensor_train_matches_one_process(sizes, tiny, tmp_path):
    _, _, sd, images = tiny
    one = workers.train_steps(None, sd, images, 2)
    world = sizes[0] * sizes[1] * sizes[2]
    out = _run(workers.sharded_train, world, tmp_path, sizes, sd, images, 2)
    for losses, norms, params in out[:2]:   # tensor peers alike
        np.testing.assert_allclose(losses, one[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(norms, one[1], rtol=NORM_RTOL)
        assert losses[1] < losses[0]
        _assert_params_close(params, one[2])


def test_tensor_step_matches_jax_sharded_step(tiny, tmp_path):
    """One step on (1, 2, 2) against the JAX step jitted over its virtual
    (1, 2, 2) mesh with XLA attention, from the same parameters and images
    (no decay, as tests/test_torch_parallel.py says)."""
    jm, params, sd, images = tiny
    mesh = j_make_mesh(data=1, fsdp=2, tensor=2, devices=jax.devices()[:4])
    opt = j_adamw(weight_decay=0.0)
    step = jax.jit(j_make_train_step(
        lambda p, b: (jm.forward(p, b, policy=J_FP32)[0], {}), opt,
        j_step_lr(LR, 1e-4, 100)))
    state = JTrainState.create(shard_params(params, mesh), opt)
    state, metrics = step(state, jax.device_put(images, batch_sharding(mesh)),
                          jnp.int32(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params), jm.cfg)

    losses, norms, got = _run(workers.sharded_train, 4, tmp_path, (1, 2, 2),
                              sd, images, 1, 0.0)[0]
    np.testing.assert_allclose(losses[0], float(metrics["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms[0], float(metrics["grad_norm"]),
                               rtol=1e-4)
    _assert_params_close(got, {k: v.numpy() for k, v in want.items()})


def test_tensor_checkpoint_crosses_meshes(tiny, tmp_path):
    """Saved on (1, 2, 2) after two steps with bf16 moments; restored on
    (2, 2, 1), on (1, 1, 2) and in one process: parameters and moments bit
    for bit, the moments still bf16, the file in the reference's layout."""
    _, _, sd, images = tiny
    path = str(tmp_path / "ck" / "latest.pt")
    saved_params, saved_moments = _run(
        workers.save_sharded, 4, tmp_path, (1, 2, 2), sd, images, path,
        store="a")[0]
    blob, _ = load_checkpoint(path)
    for name, want in saved_params.items():
        np.testing.assert_array_equal(blob["model"][name].numpy(), want)
    four = _run(workers.restore_sharded, 4, tmp_path, (2, 2, 1), path,
                store="b")
    two = _run(workers.restore_sharded, 2, tmp_path, (1, 1, 2), path,
               store="c")
    one = workers.restore_one(path)
    for restored, step, params, moments, _ in (four[0], two[1], one):
        assert restored and step == 2
        for name, want in saved_params.items():
            np.testing.assert_array_equal(params[name], want, err_msg=name)
            dtype, m, v = moments[name]
            assert dtype == "torch.bfloat16"
            np.testing.assert_array_equal(m, saved_moments[name][1])
            np.testing.assert_array_equal(v, saved_moments[name][2])
    assert two[0][4]["blocks.0.attn.qkv.weight"] == (96, 64)
    assert two[0][4]["blocks.0.attn.proj.weight"] == (64, 32)
    assert four[0][4]["blocks.0.attn.qkv.weight"] == (96, 64)


# ---------------------------------------------------- counting the ranks

def test_tensor_peers_count_once(tmp_path):
    """On (2, 1, 2): tensor peers take the same rows and the same train
    stream; meters, confusion matrices and means over ranks count each
    data rank once, given the mesh (every process without one); rank 0
    alone is the main process."""
    make_fake_wds_shard(tmp_path / "t-000000.tar", num_samples=16, size=40,
                        seed=0)
    make_fake_wds_shard(tmp_path / "t-000001.tar", num_samples=16, size=40,
                        seed=1)
    out = _run(workers.tensor_plumbing, 4, tmp_path,
               str(tmp_path / "t-{000000..000001}.tar"))
    for rank, r in enumerate(out):
        index = rank // 2
        assert r["tensor_rank"] == rank % 2
        assert r["data_rank"] == (index, 2)
        assert r["rows"] == list(range(4 * index, 4 * index + 4))
        assert r["main"] == (rank == 0)
        # data rank k adds k + 1 values 10 k + v, each twice
        assert r["count"] == 2 * (1 + 2)
        assert r["total"] == 2 * (0 + 10 + 11)
        want = np.zeros((3, 3), np.int64)
        for k in range(2):
            for t, p in zip([0, 1, 2], [k % 3, 1, 0]):
                want[t, p] += 1
        np.testing.assert_array_equal(r["mat"], want)
        assert r["mean"] == 0.5
        assert r["real_rows"] == pytest.approx(sum(range(6)) / 6)
        assert r["ones"] == 2.0
        assert r["ones_all"] == 4.0          # no mesh: every process
    for peer in (1, 3):
        for a, b in zip(out[peer]["loader"], out[peer - 1]["loader"]):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(out[0]["loader"][0], out[2]["loader"][0])


# --------------------------------------------------------------- drivers

NAME = "tae_patch16_vocab16_px256"
TINY_ARGS = json.dumps(dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
                            decoder_embed_dim=64, decoder_depth=2,
                            decoder_num_heads=4))
COMMON = ["--model", NAME, "--model_args", TINY_ARGS, "--input_size", "64",
          "--num_workers", "0", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def like_a_rank():
    """The one-process runs as a spawned rank runs: the PIL decoder and one
    thread."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TAE_TPU_NATIVE", "0")
    mp.delenv("WORLD_SIZE", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_data")
    make_fake_wds_shard(d / "train-000000.tar", num_samples=16, size=72, seed=0)
    make_fake_wds_shard(d / "train-000001.tar", num_samples=16, size=72, seed=1)
    make_fake_imagefolder(d / "val", num_classes=2, per_class=5, size=72)
    make_fake_coco(d / "coco", n_train=8, n_val=2, size=64, seed=3)
    return d


def _tensor_two(tmp_path, module, argv):
    return spawn.run(workers.driver, 2, module.__name__,
                     argv + ["--mesh_tensor", "2"],
                     store=str(tmp_path / "store"), timeout=TIMEOUT)


def test_evaluate_tensor_two_matches_one(data, tmp_path):
    argv = COMMON + ["--batch_size_per_gpu", "4", "--val_data_path",
                     str(data / "val"), "--save_prefix", "ev"]
    one = evaluate.main(evaluate.get_args_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "one")]))
    two = _tensor_two(tmp_path, evaluate,
                      argv + ["--output_dir", str(tmp_path / "two")])
    assert two[0] == two[1]
    assert two[0] == pytest.approx(one, rel=BF16_RTOL)


def test_train_tensor_two_matches_one(data, tmp_path):
    """Tensor peers train on the same rows: the one process reads the same
    stream (data rank 0 of 1) and logs the same losses; rank 0 alone
    writes the log and the checkpoint."""
    argv = COMMON + [
        "--num_its", "4", "--save_freq", "3", "--batch_size_per_gpu", "4",
        "--train_data_path", str(data / "train-{000000..000001}.tar"),
        "--val_data_path", str(data / "val"), "--save_prefix", "tr"]
    train.main(train.get_args_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "one")]))
    _tensor_two(tmp_path, train, argv + ["--output_dir", str(tmp_path / "two")])

    def rows(out):
        return [json.loads(x) for x in (tmp_path / out / "tr_log.txt")
                .read_text().splitlines()]

    one, two = rows("one"), rows("two")
    assert len(one) == len(two) == 1
    for key in ("train_loss", "train_grad_norm", "eval_loss"):
        assert two[0][key] == pytest.approx(one[0][key], rel=BF16_RTOL), key
    blob, _ = load_checkpoint(tmp_path / "two" / "tr_checkpoint_latest")
    assert blob["model"]["blocks.0.attn.qkv.weight"].shape == (192, 64)


def test_encode_tensor_two_writes_each_shard_once(data, tmp_path):
    """Tensor peers encode the same rows; tensor rank 0 alone writes the
    shards, and the index lists each once: one process's shards."""
    argv = COMMON + [
        "--batch_size", "4", "--shard_size", "6", "--deterministic",
        "--data_path", str(data / "train-{000000..000001}.tar"),
        "--save_prefix", "enc"]
    encode.main(encode.get_args_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "one")]))
    stats = _tensor_two(tmp_path, encode,
                        argv + ["--output_dir", str(tmp_path / "two")])
    assert [s["num_samples"] for s in stats] == [32, 32]
    assert [s["shards_written"] for s in stats] == [6, 0]

    def shards(out):
        index = json.loads((tmp_path / out / "enc_index.json").read_text())
        return index, sorted(p.name for p in
                             (tmp_path / out).glob("enc_latents-*"))

    (i1, n1), (i2, n2) = shards("one"), shards("two")
    assert n2 == n1 == sorted(s["path"] for s in i2["shards"])
    assert i2 == i1 and i2["num_samples"] == 32
    for name in n1:
        a, b = (np.load(tmp_path / out / name) for out in ("one", "two"))
        np.testing.assert_array_equal(b["targets"], a["targets"])
        np.testing.assert_allclose(b["latents"].astype(np.float32),
                                   a["latents"].astype(np.float32),
                                   rtol=0, atol=BF16_LATENT_ATOL)


def test_segmentation_tensor_two_matches_one(data, tmp_path):
    """The segmentation driver on (1, 1, 2): the segmenter split and
    sharded, the float frozen encoder split; the logged loss and mean IoU
    against one process."""
    argv = [
        "--dataset", "coco", "--data_path", str(data / "coco"),
        "--model", "vit_segmentation_numpatches16_vocab256_base",
        "--model_args", json.dumps(dict(vocab_size=16, decoder_embed_dim=48,
                                        decoder_depth=2, decoder_num_heads=4,
                                        patch_size=16)),
        "--encoder", NAME, "--encoder_args", TINY_ARGS, "--input_size", "64",
        "--batch_size_per_gpu", "4", "--epochs", "1", "--workers", "0",
        "--lr", "1e-3", "--print_freq", "1", "--device", "cpu"]
    parser = train_segmentation.get_args_parser()
    train_segmentation.main(parser.parse_args(
        argv + ["--output_dir", str(tmp_path / "one")]))
    _tensor_two(tmp_path, train_segmentation,
                argv + ["--output_dir", str(tmp_path / "two")])

    def row(out):
        return json.loads((tmp_path / out / "seg_log.txt").read_text()
                          .strip().splitlines()[0])

    one, two = row("one"), row("two")
    assert two["train_loss"] == pytest.approx(one["train_loss"],
                                              rel=BF16_RTOL)
    assert abs(two["mean_iou"] - one["mean_iou"]) <= MIOU_ATOL
