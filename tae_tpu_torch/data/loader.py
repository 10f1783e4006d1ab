"""Batch assembly, worker processes for decoding, and device prefetch
(counterpart of ``tae_tpu/data/loader.py``).

  * ``BatchLoader`` runs the sample pipeline inline or across N spawned
    worker processes (workers never touch the card: numpy, PIL and the
    native decoder), each assembling whole batches from its own shard
    subset, consumed round-robin; copied from the JAX package, except that
    a worker's batch arrays reach the consumer in shared memory;
  * ``device_prefetch`` keeps ``depth`` batches in flight to the card:
    pinned host tensors, ``non_blocking`` copies on a side CUDA stream, and
    the consuming stream waits on each batch's event, so the copy of batch
    k+1 overlaps step k. On the CPU it hands back plain tensors.
"""

from __future__ import annotations

import collections
import itertools
import multiprocessing as mp
import multiprocessing.connection  # noqa: F401 - mp.connection.wait
import queue as queue_mod
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

# max samples a rebatch worker buffers/ships per queue item (memory cap)
_REBATCH_CHUNK = 256
# the consumer looks at its workers this often while it waits, and gives up
# after this long without a batch
_POLL_S, _STALL_S = 5.0, 600.0
# a worker's batch arrays from this size cross in shared memory
_SHARED_BYTES = 1 << 20


def default_collate(samples: list[Any]) -> Any:
    """Stack a list of (nested tuples of) arrays/scalars into batch arrays."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


def batched(it: Iterable[Any], batch_size: int, drop_last: bool = False,
            collate: Callable = default_collate) -> Iterator[Any]:
    buf: list[Any] = []
    for x in it:
        buf.append(x)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf and not drop_last:
        yield collate(buf)


def _shared(a):
    """A worker's batch array as it crosses to the consumer: one of
    ``_SHARED_BYTES`` or more as a tensor, which the queue moves through
    shared memory (torch's reductions: the pages, not a pickled copy down
    the pipe, which some hosts carry at under 100 MB/s); a smaller one as
    it is."""
    if isinstance(a, np.ndarray) and a.nbytes >= _SHARED_BYTES:
        import torch.multiprocessing  # noqa: F401 - registers the reductions

        return torch.from_numpy(np.ascontiguousarray(a))
    return a


def _unshared(a):
    return a.numpy() if isinstance(a, torch.Tensor) else a


def _worker_main(make_iter, worker_id: int, num_workers: int, batch_size: int,
                 drop_last: bool, prebatched: bool, rebatch: bool,
                 q: mp.Queue) -> None:
    try:
        it = make_iter(worker_id, num_workers)
        if rebatch:
            # ship uncollated sample chunks; the consumer assembles exact
            # batches so the dataset tail is ONE partial batch, not one per
            # worker (matters for mean-of-batch-means eval parity). Chunks are
            # capped well below batch_size: each worker buffering a full
            # 8192-image eval batch would hold ~6 GB × num_workers on the host.
            chunk_size = min(batch_size, _REBATCH_CHUNK)
            for chunk in batched(it, chunk_size, collate=list):
                q.put(("chunk", chunk))
        else:
            if not prebatched:
                it = batched(it, batch_size, drop_last)
            for batch in it:
                q.put(("batch", _tree_map(_shared, batch)))
        q.put(("end", worker_id))
        # batches cross as file descriptors that this process hands out as
        # the consumer unpickles them: stay until the consumer ends the
        # workers (or dies)
        mp.connection.wait([mp.parent_process().sentinel])
    except KeyboardInterrupt:  # pragma: no cover
        pass
    except Exception as e:  # pragma: no cover - surfaced to the consumer
        q.put(("error", f"{type(e).__name__}: {e}"))


class BatchLoader:
    """Iterate batches from ``make_iter(worker_id, num_workers)``.

    ``make_iter`` must be picklable (top-level function / functools.partial)
    when ``num_workers > 0``; each worker streams a disjoint shard subset
    (shard-level splitting is the reader's job via worker_id/num_workers).

    ``prebatched=True`` means ``make_iter`` already yields whole batches
    (e.g. the native ``decode_batch`` path, which decodes straight into the
    batch buffer — measured 1.7x the per-sample path, which loses ~40% of
    host time to the ``np.stack`` collate copy).

    ``rebatch=True`` assembles exact-size batches on the consumer from
    uncollated worker sample chunks, so a finite dataset ends in exactly ONE
    partial batch instead of one per worker — required for the reference's
    mean-of-batch-means eval metric (train.py:220) to be loader-invariant.
    """

    def __init__(self, make_iter: Callable[[int, int], Iterable[Any]],
                 batch_size: int, num_workers: int = 0, drop_last: bool = False,
                 prefetch_batches: int = 4, prebatched: bool = False,
                 rebatch: bool = False):
        if rebatch and prebatched:
            raise ValueError("rebatch and prebatched are mutually exclusive")
        self.make_iter = make_iter
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.prebatched = prebatched
        self.rebatch = rebatch

    def __iter__(self) -> Iterator[Any]:
        if self.num_workers == 0:
            if self.prebatched:
                yield from self.make_iter(0, 1)
            else:
                yield from batched(self.make_iter(0, 1), self.batch_size,
                                   self.drop_last)
            return
        ctx = mp.get_context("spawn")
        q: mp.Queue = ctx.Queue(maxsize=max(2, self.prefetch_batches))
        procs = [
            ctx.Process(target=_worker_main,
                        args=(self.make_iter, i, self.num_workers,
                              self.batch_size, self.drop_last, self.prebatched,
                              self.rebatch, q),
                        daemon=True)
            for i in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        live = self.num_workers
        buf: list[Any] = []  # rebatch sample buffer
        try:
            waited = 0.0
            while live:
                try:
                    kind, payload = q.get(timeout=_POLL_S)
                except queue_mod.Empty:
                    # a worker that died before its "end" (killed, or failed
                    # to start) would otherwise hold the consumer forever
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a data worker died (exit codes "
                                           f"{dead})") from None
                    waited += _POLL_S
                    if waited >= _STALL_S:  # pragma: no cover
                        raise RuntimeError(
                            f"data workers stalled for {_STALL_S:.0f}s") from None
                    continue
                waited = 0.0
                if kind == "batch":
                    yield _tree_map(_unshared, payload)
                elif kind == "chunk":
                    buf.extend(payload)
                    while len(buf) >= self.batch_size:
                        yield default_collate(buf[:self.batch_size])
                        buf = buf[self.batch_size:]
                elif kind == "end":
                    live -= 1
                else:
                    raise RuntimeError(f"data worker failed: {payload}")
            if buf and not self.drop_last:
                yield default_collate(buf)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def device_prefetch(batches: Iterable[Any], device: torch.device | str = "cuda",
                    depth: int = 2) -> Iterator[Any]:
    """Move batches (numpy arrays, or tuples / lists / dicts of them) to
    ``device`` ahead of their consumer. On a CUDA device each batch is
    pinned and copied with ``non_blocking`` on a side stream, ``depth``
    batches ahead; a yielded batch is ready on the current stream (which
    waits on the copy's event) and is recorded there, so its memory is not
    reused while that stream may still read it. On the CPU the arrays come
    back as tensors sharing their memory."""
    device = torch.device(device)
    it = iter(batches)
    if device.type != "cuda":
        for batch in it:
            yield _tree_map(_as_tensor, batch)
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        host = _tree_map(lambda a: _as_tensor(a).pin_memory(), batch)
        with torch.cuda.stream(side):
            dev = _tree_map(lambda t: t.to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(side)
        return dev, done, host      # the pinned source lives until the copy

    buf: collections.deque = collections.deque(
        put(b) for b in itertools.islice(it, depth))
    while buf:
        dev, done, _ = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        _tree_map(lambda t: t.record_stream(stream), dev)
        yield dev
