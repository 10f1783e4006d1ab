"""Run a function in ``world`` fresh processes joined by gloo on the CPU:
the multi-process runs of :mod:`tae_tpu_torch.dryrun` and of the CPU tests.

Each process uses one thread and meets the others through a ``FileStore``
(a file path, so concurrent runs cannot collide on a port). The parent
waits for every rank up to ``timeout`` seconds, then kills what is left and
raises: a hang costs its timeout, never the caller's whole budget.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback


def _entry(fn, rank: int, world: int, store: str, out, args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))


def run(fn, world: int, *args, store: str, timeout: float = 180.0) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each rank in
    its own spawned process inside a gloo group of ``world`` (``store``: a
    path that does not exist yet). ``fn`` and its results must pickle.
    Raises with the first failing rank's traceback (the others are
    killed), or on the timeout."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, out, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            try:
                # a second at a time: a rank that dies without a word
                # (a signal) is seen at once, not at the timeout
                rank, ok, value = out.get(timeout=min(max(left, 0.01), 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if left <= 0 or dead:
                    raise TimeoutError(
                        f"{world} processes: ranks {sorted(results)} "
                        f"returned, {sorted(errors)} failed, exit codes "
                        f"{[p.exitcode for p in procs]} after "
                        f"{timeout - max(left, 0):.0f} s") from None
                continue
            (results if ok else errors)[rank] = value
            if errors:
                break   # the others may wait on the failed rank forever
    finally:
        for p in procs:
            p.join(timeout=5.0 if errors else
                   max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(f"rank {r}:\n{tb}"
                                     for r, tb in sorted(errors.items())))
    return [results[r] for r in range(world)]
