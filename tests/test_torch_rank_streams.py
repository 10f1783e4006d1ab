"""Each rank's own train stream (``tae_tpu_torch.cli._common
.wds_train_loader``, the loader of the train and in19k drivers) against the
JAX package's stream of a process (``tae_tpu.cli._common._wds_train_iter``
with ``process_index`` and ``process_count``): the same shard subset, seeds
and images, bit for bit; the ranks' shards disjoint; and each rank's loader
yielding its own rows of the global batch. Both sides decode with PIL.
"""

import argparse
import itertools

import numpy as np
import pytest

from tae_tpu.cli import _common as jcommon
from tae_tpu.data import native as jnative
from tae_tpu_torch.cli import _common
from tae_tpu_torch.data.fake import make_fake_wds_shard
from tae_tpu_torch.parallel import sharding

SHARDS = 6
SEED, SIZE, TAKE = 3, 32, 6
SCALE, RATIO = (0.2, 1.0), (3 / 4, 4 / 3)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    d = tmp_path_factory.mktemp("rank_streams")
    for i in range(SHARDS):
        make_fake_wds_shard(d / f"train-{i:06d}.tar", num_samples=64, size=40,
                            seed=i)
    return str(d / f"train-{{000000..{SHARDS - 1:06d}}}.tar")


@pytest.fixture(autouse=True)
def pil(monkeypatch):
    monkeypatch.setenv("TAE_TPU_NATIVE", "0")
    monkeypatch.setattr(jnative, "available", lambda: False)


def _stream(module, monkeypatch, path, rank, ranks, worker, workers):
    """The first TAKE samples of ``module``'s per-sample train stream of
    process ``rank`` of ``ranks``, worker ``worker`` of ``workers``, and
    what its shard reader was given."""
    seen = {}

    class Recording(module.WebDatasetReader):
        def __init__(self, spec, **kw):
            super().__init__(spec, **kw)
            seen.update(seed=spec.seed, shard_index=kw["shard_index"],
                        shard_count=kw["shard_count"], urls=list(self.urls))

    monkeypatch.setattr(module, "WebDatasetReader", Recording)
    items = list(itertools.islice(module._wds_train_iter(
        path, SIZE, SCALE, RATIO, SEED, rank, ranks, worker, workers), TAKE))
    return items, seen


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_rank_stream_matches_jax_process_stream(path, monkeypatch, ranks,
                                                workers):
    for rank in range(ranks):
        for worker in range(workers):
            got, got_reader = _stream(_common, monkeypatch, path, rank, ranks,
                                      worker, workers)
            want, want_reader = _stream(jcommon, monkeypatch, path, rank,
                                        ranks, worker, workers)
            assert got_reader == want_reader
            assert got_reader["shard_index"] == rank * workers + worker
            assert got_reader["shard_count"] == ranks * workers
            assert got_reader["seed"] == SEED + 1000 * rank + worker
            assert len(got) == len(want) == TAKE
            for (x, t), (y, u) in zip(got, want):
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x, y)
                assert t == u


@pytest.mark.parametrize("ranks", [2, 3])
def test_rank_shards_are_disjoint(path, monkeypatch, ranks):
    shards = []
    for rank in range(ranks):
        mine = set()
        for worker in range(2):
            _, reader = _stream(_common, monkeypatch, path, rank, ranks,
                                worker, 2)
            mine.update(reader["urls"])
        shards.append(mine)
    for a, b in itertools.combinations(shards, 2):
        assert not a & b
    assert len(set().union(*shards)) == SHARDS


def _args(path):
    return argparse.Namespace(train_data_path=path, input_size=SIZE,
                              seed=SEED, num_workers=0, device_normalize=False,
                              jitter_scale=list(SCALE), jitter_ratio=list(RATIO))


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_loader_yields_its_own_rows(path, monkeypatch, rank):
    """A rank's loader: the global batch of 8 over two ranks, 4 rows a batch,
    the first rows of its own stream (the JAX process stream's)."""
    monkeypatch.setattr(sharding, "data_rank", lambda mesh: (rank, 2))
    imgs, targets = next(iter(_common.wds_train_loader(_args(path), 8,
                                                       mesh=object())))
    want, _ = _stream(jcommon, monkeypatch, path, rank, 2, 0, 1)
    assert imgs.shape == (4, 3, SIZE, SIZE)
    np.testing.assert_array_equal(imgs, np.stack([x for x, _ in want[:4]]))
    np.testing.assert_array_equal(targets, [t for _, t in want[:4]])


def test_rank_loader_refuses_an_uneven_batch(path, monkeypatch):
    monkeypatch.setattr(sharding, "data_rank", lambda mesh: (0, 3))
    with pytest.raises(ValueError, match="does not divide"):
        _common.wds_train_loader(_args(path), 8, mesh=object())
