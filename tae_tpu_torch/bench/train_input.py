"""Where the train driver's iterations go: its input pipeline alone, and
its step alone.

* ``loader``: ``cli/_common.wds_train_loader`` (the driver's loader: the
  native decoder where it builds, else PIL: on a thread pool with at most
  one worker process, a sample at a time in each of several) for each
  ``--workers`` count, ``--batches`` batches of ``--batch`` images after the
  first (which fills the shuffle buffers and starts the workers): the mean
  seconds a batch and images a second; with ``--prefetch`` also through
  ``data.loader.device_prefetch`` to the card;
* ``step``: ``make_train_step`` on ``--model`` with the convergence run's
  recipe (fp32 parameters, bf16 compute, AdamW, ``--accum_iter``
  microbatches of ``--batch`` / ``--accum_iter``, ``--remat``, CUDA graphs)
  on one seeded device batch: the host wall of each step to a synchronize.

The slower of the two sets the driver's pace. Run from the repository
root, on a machine with a CUDA card for ``step``::

    python -m tae_tpu_torch.bench.train_input --data 'd/train-{000000..000023}.tar' \\
        --batch 256 --workers 0 1 6 [--float] [--prefetch] \\
        [--step --accum_iter 4 --remat]
"""

from __future__ import annotations

import argparse
import statistics
import time
from types import SimpleNamespace

import torch


def time_loader(data: str, batch: int, workers: int, batches: int,
                input_size: int, prefetch: bool, u8: bool = True
                ) -> list[float]:
    """Seconds of each batch after the first (``u8``: uint8 batches, as
    with ``--device_normalize``; else normalized float32)."""
    from tae_tpu_torch.cli import _common
    from tae_tpu_torch.data.loader import device_prefetch

    args = SimpleNamespace(train_data_path=data, input_size=input_size,
                           num_workers=workers, seed=0,
                           device_normalize=u8)
    stream = (x for x, _ in _common.wds_train_loader(args, batch))
    if prefetch:
        stream = device_prefetch(stream, "cuda")
    out, t = [], None
    for i, x in enumerate(stream):
        if prefetch:
            torch.cuda.synchronize()
        now = time.perf_counter()
        if t is not None:
            out.append(now - t)
        t = now
        if i == batches:
            break
    return out


def time_step(model_name: str, batch: int, accum_iter: int, remat: bool,
              steps: int) -> list[float]:
    """Host wall of each of ``steps`` train steps, to a synchronize."""
    from tae_tpu_torch import models
    from tae_tpu_torch.serving_graphs import GraphPool
    from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
    from tae_tpu_torch.utils.dtypes import Policy

    model = models.create(model_name, device="cuda", trainable=True)
    model.init_weights_(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(weight_decay=0.0)
    state = TrainState.create(model, opt)
    policy = Policy()

    def loss_fn(m, imgs):
        loss, _ = m(imgs, policy=policy, remat=remat)
        return loss, {}

    step = make_train_step(loss_fn, opt, step_lr(1e-4, 1e-5, 900_000),
                           accum_iter=accum_iter, cuda_graphs=True,
                           pool=GraphPool())
    gen = torch.Generator(device="cuda").manual_seed(1)
    size = model.cfg.img_size
    x = torch.randn((batch, 3, size, size), generator=gen, device="cuda")
    out = []
    for it in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, x, it)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("the train driver's input and step, apart")
    p.add_argument("--data", default="")
    p.add_argument("--batch", default=256, type=int)
    p.add_argument("--workers", default=[1], type=int, nargs="+")
    p.add_argument("--batches", default=24, type=int)
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--prefetch", action="store_true")
    p.add_argument("--float", action="store_true",
                   help="normalized float32 batches (no --device_normalize)")
    p.add_argument("--step", action="store_true")
    p.add_argument("--model", default="tae_patch16_vocab16_px256")
    p.add_argument("--accum_iter", default=4, type=int)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--steps", default=8, type=int)
    args = p.parse_args(argv)
    if torch.cuda.is_available():
        from tae_tpu_torch.profile_serving import card_line

        print(card_line(), flush=True)
    from tae_tpu_torch.data import native

    if args.data:
        print(f"decoder: {native.decoder_name()}", flush=True)
        for w in args.workers:
            dts = time_loader(args.data, args.batch, w, args.batches,
                              args.input_size, args.prefetch, not args.float)
            # the mean: workers queue batches ahead, so single batches
            # come in bursts
            mean = sum(dts) / len(dts)
            print(f"[loader] {w} workers{' + prefetch' if args.prefetch else ''}"
                  f", {'float32' if args.float else 'uint8'}: {mean:.3f} s a "
                  f"batch of {args.batch} (mean of {len(dts)}; "
                  f"{min(dts):.3f}-{max(dts):.3f}), "
                  f"{args.batch / mean:.1f} img/s", flush=True)
    if args.step:
        dts = time_step(args.model, args.batch, args.accum_iter, args.remat,
                        args.steps)
        med = statistics.median(dts[2:]) if len(dts) > 2 else dts[-1]
        print(f"[step] {args.model} B={args.batch} accum_iter "
              f"{args.accum_iter} remat {args.remat}: each step "
              + ", ".join(f"{d:.3f}" for d in dts)
              + f" s; steps 2-: median {med:.3f} s, "
              f"{args.batch / med:.1f} img/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
