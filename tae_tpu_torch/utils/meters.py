"""Metric meters, logging and JSONL output (counterpart of
``tae_tpu/utils/meters.py``; the JSONL schema is unchanged): windowed
``SmoothedValue`` meters, a ``MetricLogger`` printing iteration and data
timings, and :func:`append_jsonl`, one ``{"train_loss": ..., "eval_loss":
..., "iteration": ...}`` object a line.

A value may be a 0-dim tensor on the card; it is read (a synchronize) only
inside ``update``. The JAX package's device metric ring, which batches those
reads over a high-latency link, has no counterpart: the train driver reads
each step's metrics one step behind instead (``tae_tpu_torch.cli.train``).
"""

from __future__ import annotations

import datetime
import json
import time
from collections import defaultdict, deque
from pathlib import Path

import numpy as np
import torch


def _to_float(v) -> float:
    # device scalar / numpy / python -> host float (single sync point)
    if isinstance(v, torch.Tensor):
        return float(v)
    return float(np.asarray(v))


class SmoothedValue:
    """Track a series of values; expose window-smoothed and global stats."""

    def __init__(self, window_size: int = 20, fmt: str | None = None):
        self.deque: deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1) -> None:
        value = _to_float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self, mesh=None) -> None:
        """Sum count/total across processes, in float64 (reference
        util/misc.py:42-53), the tensor peers of ``mesh`` counted once
        (``parallel.mesh.all_reduce_sum``); nothing to do in a world of 1."""
        from tae_tpu_torch.parallel.mesh import all_reduce_sum, world_size

        if world_size() == 1:
            return
        count, total = all_reduce_sum([self.count, self.total], mesh)
        self.count, self.total = int(count), float(total)

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, n: int = 1, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(v, n=n)

    def __getattr__(self, attr: str) -> SmoothedValue:
        meters = self.__dict__.get("meters", {})
        if attr in meters:
            return meters[attr]
        raise AttributeError(f"{type(self).__name__!r} has no attribute {attr!r}")

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self, mesh=None) -> None:
        for m in self.meters.values():
            m.synchronize_between_processes(mesh)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def global_avgs(self) -> dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable, print_freq: int, header: str = "",
                  total: int | None = None):
        """Yield from ``iterable`` printing progress/meters/timings every
        ``print_freq`` items (reference util/misc.py:115-158)."""
        i = 0
        if total is None:
            total = len(iterable) if hasattr(iterable, "__len__") else None
        start = time.time()
        end = start
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total is not None:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i}/{total}] eta: {eta_str} {self} "
                          f"time: {iter_time} data: {data_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} "
                          f"data: {data_time}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)


def append_jsonl(path: str | Path, record: dict) -> None:
    """Append one JSON line — the reference's log-file format
    (train.py:180-182). Rank-0 gating is the caller's job."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")
