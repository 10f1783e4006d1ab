"""Time what reading a train step's metrics costs the train driver
(``cli/train.py``): ``--steps`` steps of ``profile_training``'s recipe
(``--model`` at full size, fp32 parameters, bf16 compute, AdamW) on one
seeded batch, read three ways:

* ``none``: no fetch and no read (the step's call alone);
* ``behind``: the driver's way, ``fetch_metrics`` after each step and
  ``host_metrics`` of step k once step k+1 is queued;
* ``every``: each step fetched and read as soon as it is queued (the
  reference driver's ``loss.item()``).

``--rounds`` rounds, the order of the ways reversed each round, after
``--warmup`` steps; prints the median ms per step of each way with its
spread over the rounds, and the host's time to queue a step (``none``).

Run on a machine with a CUDA card, from the repository root::

    python -m tae_tpu_torch.bench.train_read --steps 20 --rounds 7
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

MODES = ("none", "behind", "every")


def run_mode(mode: str, step, state, batch, steps: int,
             queue: list[float]) -> float:
    """ms per step of ``steps`` steps read the ``mode`` way."""
    from tae_tpu_torch.cli._common import fetch_metrics, host_metrics

    torch.cuda.synchronize()
    t = time.perf_counter()
    pending = None
    for it in range(steps):
        q = time.perf_counter()
        _, metrics = step(state, batch, it)
        if mode == "none":
            queue.append(time.perf_counter() - q)
            continue
        fetched = fetch_metrics(metrics)
        if mode == "every":
            host_metrics(fetched)
        elif pending is not None:
            host_metrics(pending)
        pending = fetched
    if pending is not None:
        host_metrics(pending)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / steps * 1e3


def main(argv=None) -> int:
    from tae_tpu_torch.profile_serving import card_line
    from tae_tpu_torch.profile_training import build_state, make_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tae_patch16_vocab256_px256")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--warmup", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    print(card_line())
    state, step = build_state(args.model), make_step()
    cfg = state.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = torch.randn((args.batch, cfg.in_chans, cfg.img_size, cfg.img_size),
                        generator=gen, device="cuda")
    queue: list[float] = []
    run_mode("every", step, state, batch, args.warmup, queue)
    res = {m: [] for m in MODES}
    for r in range(args.rounds):
        for mode in (MODES if r % 2 == 0 else MODES[::-1]):
            res[mode].append(run_mode(mode, step, state, batch, args.steps,
                                      queue))
    ms = {m: statistics.median(v) for m, v in res.items()}
    print(f"== {args.model} train step B={args.batch}, medians of "
          f"{args.rounds} rounds of {args.steps} steps, in turns:")
    for m in MODES:
        print(f"  {m:7s} {ms[m]:9.3f} ms/step  ({ms[m] / ms['none'] - 1:+.2%} "
              f"against none; rounds {min(res[m]):.3f}-{max(res[m]):.3f})")
    print(f"  the host queues a step in {statistics.median(queue) * 1e3:.3f} ms "
          f"(median, none)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
