"""Where the time of a serving request goes, by CUDA kernel.

Run on a machine with a CUDA card, from the repository root::

    python -m tae_tpu_torch.profile_serving --quantization int8 --batches 64 8 1
    python -m tae_tpu_torch.profile_serving --model tae_patch128_vocab4096_px256 \
        --quantization int4
    python -m tae_tpu_torch.profile_serving --model tae_patch128_vocab4096_px256 \
        --quantization int8 --attn-q8 off
    python -m tae_tpu_torch.profile_serving --codebook-size 8192 --depth 2 \
        --direction discrete

Builds the named model (``--model``, any registered config) at full size
(``--depth`` cuts its encoder and decoder to that many blocks each;
``--codebook-size`` adds the VQ bottleneck) with seeded random weights,
serves ``--requests`` encode (or decode, or ``encode_discrete``: token ids
through the codebook search) requests per batch size under
``torch.profiler`` after ``--warmup`` unprofiled ones, and prints per batch
size: the device time of each kernel name per request with its launches per
request, the sum over all kernels, the wall time per request (host clock to
a synchronize) and the busy share (kernel time / wall time). The card's name
and power limit head the output.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time

import torch


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def short(name: str, width: int = 72) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name if len(name) <= width else name[:width - 3] + "..."


def profile(fn, arg, requests: int) -> tuple[dict, float]:
    """({kernel name: (device ms, launches)} per request, wall ms per
    request) over ``requests`` calls of ``fn(arg)``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            fn(arg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / requests
    rows: dict = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows[ev.name][0] += ev.time_range.elapsed_us() / 1e3 / requests
            rows[ev.name][1] += 1
    return ({k: (ms, n / requests) for k, (ms, n) in rows.items()}, wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tae_patch16_vocab256_px256")
    ap.add_argument("--quantization", default=None, choices=[None, "int8", "int4"])
    ap.add_argument("--attn-q8", default="rule", choices=["rule", "on", "off"],
                    help="int8 path: the attention entry's output")
    ap.add_argument("--direction", default="encode",
                    choices=["encode", "decode", "discrete"])
    ap.add_argument("--codebook-size", type=int, default=None,
                    help="a VQ bottleneck of this many codes (quantize=True)")
    ap.add_argument("--depth", type=int, default=None,
                    help="encoder and decoder blocks each (a cut)")
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 8, 1])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from tae_tpu_torch.tokenizer import Tokenizer

    print(card_line())
    overrides = {}
    if args.codebook_size:
        overrides.update(quantize=True, codebook_size=args.codebook_size)
    if args.depth:
        overrides.update(depth=args.depth, decoder_depth=args.depth)
    tok = Tokenizer.from_checkpoint(args.model, device="cuda", seed=args.seed,
                                    quantization=args.quantization,
                                    attn_q8={"rule": None, "on": True,
                                             "off": False}[args.attn_q8],
                                    **overrides)
    cfg = tok.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    mode = args.quantization or "bf16"
    if args.quantization and args.attn_q8 != "rule":
        mode += f" attn_q8={args.attn_q8}"
    for b in args.batches:
        x = torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                          dtype=torch.uint8, device="cuda", generator=gen)
        fn = tok.encode_discrete if args.direction == "discrete" else tok.encode
        if args.direction == "decode":
            x, fn = tok.encode(x), tok.decode
        for _ in range(args.warmup):
            fn(x)
        rows, wall = profile(fn, x, args.requests)
        total = sum(ms for ms, _ in rows.values())
        print(f"== {args.model} {mode} {args.direction} B={b}: kernels "
              f"{total:.3f} ms, wall {wall:.3f} ms per request, busy share "
              f"{total / wall:.3f}")
        for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:9.4f} ms  {100 * ms / total:5.1f}%  x{n:<6g} "
                  f"{short(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
