"""The port's multi-process entry points on the CPU: the dry run of every
training topology (``tae_tpu_torch.dryrun``, the counterpart of
``__graft_entry__.dryrun_multichip``) and the three TAE drivers run as two
ranks of a torchrun launch against one process.

Processes run through ``tae_tpu_torch.parallel.spawn`` (one thread each, a
``FileStore`` under ``tmp_path``, killed at a timeout); the drivers take
the PIL decoder (``TAE_TPU_NATIVE=0``) on both sides.
"""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_parallel_workers as workers
from tae_tpu_torch import dryrun
from tae_tpu_torch.cli import _common, encode, evaluate, train
from tae_tpu_torch.data.fake import make_fake_imagefolder, make_fake_wds_shard
from tae_tpu_torch.parallel import sharding, spawn

TIMEOUT = 180
NAME = "tae_patch16_vocab16_px256"
TINY = json.dumps(dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
                       decoder_embed_dim=64, decoder_depth=2,
                       decoder_num_heads=4))
COMMON = ["--model", NAME, "--model_args", TINY, "--input_size", "64",
          "--num_workers", "0", "--device", "cpu"]
# two ranks against one process: fp32 sums in another order (the eval loss
# as tests/test_cli.py::test_eval_sharded_matches_single_device holds the
# JAX package's; train losses, gradient norms and the eval after three
# AdamW steps, the one process accumulating each rank's rows as a
# microbatch, so that its bf16 weight gradients round where a rank's do)
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def like_a_rank():
    """The one-process runs as a spawned rank runs: the PIL decoder and one
    thread (CPU GEMMs block their sums by the thread count)."""
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
    d = tmp_path_factory.mktemp("dist_data")
    make_fake_wds_shard(d / "train-000000.tar", num_samples=16, size=72, seed=0)
    make_fake_wds_shard(d / "train-000001.tar", num_samples=16, size=72, seed=1)
    make_fake_imagefolder(d / "val", num_classes=2, per_class=5, size=72)
    # two ranks with 4 and 2 batches: the sharded encoder's lockstep
    make_fake_wds_shard(d / "uneven-000000.tar", num_samples=16, size=72,
                        seed=2)
    make_fake_wds_shard(d / "uneven-000001.tar", num_samples=8, size=72,
                        seed=3)
    return d


def _two_ranks(tmp_path, module, argv):
    return spawn.run(workers.driver, 2, module.__name__, argv,
                     store=str(tmp_path / "store"), timeout=TIMEOUT)


@pytest.mark.parametrize("n", [4, 8])
def test_factor_mesh_folds_the_tensor_axis(n):
    """The dry run's mesh is the JAX dry run's, its tensor factor kept."""
    assert dryrun.factor_mesh(n) == graft._factor_mesh(n)


def test_dryrun_multichip_four(capsys):
    dryrun.dryrun_multichip(4, timeout=TIMEOUT)
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("dryrun_multichip ok:")]
    assert len(lines) == 4
    assert "tae train mesh=(1, 2, 2)" in lines[0]
    for what, line in zip(("recognition", "segmentation", "int8 serving"),
                          lines[1:]):
        assert what in line


def test_evaluate_two_ranks_match_one(data, tmp_path):
    argv = COMMON + ["--batch_size_per_gpu", "4", "--val_data_path",
                     str(data / "val"), "--save_prefix", "ev"]
    one = evaluate.main(evaluate.get_args_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "one")]))
    two = _two_ranks(tmp_path, evaluate,
                     argv + ["--output_dir", str(tmp_path / "two")])
    assert two[0] == two[1]
    assert two[0] == pytest.approx(one, rel=LOSS_RTOL)


class _RankOfTwo:
    """A stand-in mesh: rank ``rank`` of two data ranks."""

    def __init__(self, rank: int):
        self.rank = rank


def test_train_two_ranks_match_one(data, tmp_path, monkeypatch):
    """Each rank trains on its own stream's rows, a global batch of 4. The
    one process is fed the same global batches, rank 0's rows then rank
    1's, by a loader put in the driver's place, and takes each rank's rows
    as one of two microbatches."""
    argv = COMMON + [
        "--num_its", "4", "--save_freq", "3",
        "--train_data_path", str(data / "train-{000000..000001}.tar"),
        "--val_data_path", str(data / "val"), "--save_prefix", "tr"]
    rank_loader, data_rank = _common.wds_train_loader, sharding.data_rank

    def both_rank_streams(args, batch_size, mesh=None, skip_batches=0):
        assert mesh is None and skip_batches == 0
        streams = [rank_loader(args, batch_size, _RankOfTwo(rank))
                   for rank in range(2)]
        for parts in zip(*streams):
            yield tuple(np.concatenate(p) for p in zip(*parts))

    monkeypatch.setattr(sharding, "data_rank", lambda mesh: (
        (mesh.rank, 2) if isinstance(mesh, _RankOfTwo) else data_rank(mesh)))
    monkeypatch.setattr(_common, "wds_train_loader", both_rank_streams)
    train.main(train.get_args_parser().parse_args(argv + [
        "--batch_size_per_gpu", "2", "--accum_iter", "2",
        "--output_dir", str(tmp_path / "one")]))
    monkeypatch.undo()
    _two_ranks(tmp_path, train, argv + ["--batch_size_per_gpu", "4",
                                        "--output_dir", str(tmp_path / "two")])

    def rows(out):
        return [json.loads(x) for x in (tmp_path / out / "tr_log.txt")
                .read_text().splitlines()]

    one, two = rows("one"), rows("two")
    assert len(one) == len(two) == 1
    assert two[0]["train_loss"] == pytest.approx(one[0]["train_loss"],
                                                 rel=LOSS_RTOL)
    for key in ("train_grad_norm", "eval_loss"):
        assert two[0][key] == pytest.approx(one[0][key], rel=LOSS_RTOL), key
    assert (tmp_path / "two" / "tr_checkpoint_latest").exists()


@pytest.mark.parametrize("shards,fsdp,counts", [
    ("train", 1, [16, 16]), ("uneven", 2, [16, 8])])
def test_encode_two_ranks_cover_one(data, tmp_path, shards, fsdp, counts):
    """Each rank encodes one of the two input shards; rank 0 writes the
    index of both ranks' shards; their union is one process's output. With
    --mesh_fsdp 2 the encoder is sharded and the rank with fewer batches
    runs empty ones until the other is done."""
    argv = COMMON + [
        "--batch_size", "4", "--shard_size", "6", "--deterministic",
        "--data_path", str(data / f"{shards}-{{000000..000001}}.tar"),
        "--save_prefix", "enc", "--mesh_fsdp", str(fsdp)]
    encode.main(encode.get_args_parser().parse_args(
        argv[:-2] + ["--output_dir", str(tmp_path / "one")]))
    stats = _two_ranks(tmp_path, encode,
                       argv + ["--output_dir", str(tmp_path / "two")])
    assert [s["num_samples"] for s in stats] == counts

    def union(out):
        index = json.loads((tmp_path / out / "enc_index.json").read_text())
        parts = [np.load(tmp_path / out / s["path"]) for s in index["shards"]]
        assert index["num_samples"] == sum(counts)
        return (np.concatenate([p["latents"] for p in parts]),
                np.concatenate([p["targets"] for p in parts]))

    (z1, t1), (z2, t2) = union("one"), union("two")
    np.testing.assert_array_equal(t2, t1)
    np.testing.assert_allclose(z2.astype(np.float32), z1.astype(np.float32),
                               rtol=0, atol=1e-6)
    names = sorted(p.name for p in (tmp_path / "two").glob("enc_latents-*"))
    assert names[0].startswith("enc_latents-r000-")
    assert names[-1].startswith("enc_latents-r001-")
