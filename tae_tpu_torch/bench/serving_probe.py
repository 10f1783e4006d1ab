"""Where a trained tokenizer's serving error comes from: the reconstruction
MSE of one checkpoint on the first ``--num_batches`` val batches, four ways
apart, and the attention scores that the serving softmax clamps.

  - ``fp32 exact``: fp32 parameters, bf16 compute, the exact softmax (the
    train driver's eval pass);
  - ``fp32 serving``: the same with the serving softmax (scores clamped to
    [-60, 45] before the exponential, no row maximum: the JAX package's
    ``_serving_softmax``, the Tokenizer's forward);
  - ``bf16 exact``: bf16 parameters (the Tokenizer's) with the exact
    softmax (``quant_accuracy``'s bf16 row, the JAX script's forward);
  - ``bf16 serving``: the Tokenizer's ``encode`` / ``decode``.

It also prints, for every block, the largest and the smallest row maximum
of the scaled scores q·k / sqrt(dh) (fp32 products of the bf16 forward):
the serving softmax is exact while every row maximum lies in [-60, 45].

    python -m tae_tpu_torch.bench.serving_probe \\
        --ckpt .convergence/torch/out/conv_checkpoint [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from tae_tpu_torch.scripts.quant_accuracy import load_batches

CLIP = (-60.0, 45.0)


def mse(model, x: torch.Tensor, policy, serving: bool) -> float:
    with torch.inference_mode():
        z = model.forward_encoder(x, policy=policy, serving=serving)
        pred = model.forward_decoder(z, policy=policy, serving=serving)
        return float((pred.float() - model.patchify(x).float()).square()
                     .mean())


def score_range(model, x: torch.Tensor, policy) -> list[tuple[float, float]]:
    """(largest, smallest) row maximum of each block's scaled scores, in
    the order the blocks run (encoder, then decoder)."""
    from tae_tpu_torch.nn import vit

    seen = []

    def hook(attn):
        def record(module, args, out):
            b, n, _ = out.shape
            h = attn.num_heads
            q, k, _ = out.float().reshape(b, n, 3, h, -1).unbind(2)
            s = torch.einsum("bnhd,bmhd->bhnm", q, k) * q.shape[-1] ** -0.5
            rowmax = s.amax(-1)
            seen.append((float(rowmax.max()), float(rowmax.min())))
        return record

    handles = [m.qkv.register_forward_hook(hook(m))
               for m in model.modules() if isinstance(m, vit.Attention)]
    try:
        mse(model, x, policy, serving=False)
    finally:
        for hd in handles:
            hd.remove()
    return seen


def main(argv: list[str] | None = None) -> dict:
    from tae_tpu_torch import models
    from tae_tpu_torch.ckpt.io import checkpoint_step, load_params
    from tae_tpu_torch.tokenizer import Tokenizer
    from tae_tpu_torch.utils.dtypes import Policy

    p = argparse.ArgumentParser("the serving error of a trained tokenizer")
    p.add_argument("--model", default="tae_patch16_vocab16_px256")
    p.add_argument("--ckpt", default=".convergence/torch/out/conv_checkpoint")
    p.add_argument("--val_data_path", default=".convergence/torch/data/val")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--num_batches", default=4, type=int)
    p.add_argument("--model_args", default="", type=str)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(f"checkpoint {args.ckpt}: step {checkpoint_step(args.ckpt)}",
          flush=True)
    overrides = json.loads(args.model_args) if args.model_args else {}
    device = torch.device(args.device)
    model = models.create(args.model, device=device, **overrides)
    load_params(args.ckpt, model)
    model.eval()
    batches = [torch.from_numpy(b).to(device) for b in load_batches(
        args.val_data_path, model.cfg.img_size, args.batch_size,
        args.num_batches)]
    tok = Tokenizer.from_checkpoint(args.model, args.ckpt, device=device,
                                    **overrides)
    ways = {
        "fp32 exact": lambda x: mse(model, x, Policy(), False),
        "fp32 serving": lambda x: mse(model, x, Policy(), True),
        "bf16 exact": lambda x: mse(tok.model, x, tok.policy, False),
        "bf16 serving": lambda x: float((tok.decode(tok.encode(x)).float()
                                         - x.float()).square().mean()),
    }
    out = {name: sum(f(x) for x in batches) / len(batches)
           for name, f in ways.items()}
    for name, v in out.items():
        print(f"[{name}] recon MSE {v:.6f} ({v / out['fp32 exact']:.3f} x "
              f"fp32 exact)")
    scores = score_range(tok.model, batches[0], tok.policy)
    for i, (hi, lo) in enumerate(scores):
        flag = "" if CLIP[0] <= lo and hi <= CLIP[1] else "  <- clamped"
        print(f"[block {i}] row maxima of the scaled scores in "
              f"[{lo:.2f}, {hi:.2f}]{flag}")
    out["scores"] = scores
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
