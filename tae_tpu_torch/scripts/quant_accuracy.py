"""Quantized serving accuracy on trained weights (counterpart of
``scripts/quant_accuracy.py``).

For each serving mode of ``Tokenizer.from_checkpoint``, on the first
``--num_batches`` full batches of a validation ImageFolder:

  - the latents' relative error against the bf16 tokenizer's on the same
    images (Frobenius norms, fp32), averaged over the batches;
  - the reconstruction MSE with both encode and decode in the mode (the
    mean of per-batch means, in the metric space of the reference's
    evaluate.py:92-96: the MSE is the same over pixels as over patches);
  - its change against bf16 serving.

Modes: ``bf16``, ``int8``, ``int8+eq``, ``int4``, ``int4+eq``,
``int4+eq+calib`` (``equalize=0.5``; the last measures the activation
ranges on ``--calib_batches`` more batches with ``calibrate.ln_amax``). The
bf16 mode runs first; its latents stay on the device as the baseline. Every
metric is computed on the device, and only scalars reach the host.

Each mode is measured on the JAX script's forward (its ``make_steps``):
the tokenizer's model, built and quantized by ``Tokenizer.from_checkpoint``,
runs ``forward_encoder`` and ``forward_decoder`` with the exact softmax
(``serving=False``), and the MSE is taken against the patchified images.
So the error is the quantization's alone; the Tokenizer's ``encode`` /
``decode`` take the clamped serving softmax besides. On the card bf16 runs
K1 and K2; int8 adds K3, K4 and K5 (its attention is K2's exact form,
whose output a plain pass quantizes per row for proj); int4 K3, K12 and
K13 beside it; calibration runs K1 and K2 in fp32.

    python -m tae_tpu_torch.scripts.quant_accuracy \\
        --ckpt .convergence/torch/out/conv_checkpoint \\
        --val_data_path .convergence/torch/data/val [--device cpu]

Prints the checkpoint's step, a markdown table and one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

MODES = {
    "bf16": dict(),
    "int8": dict(quantization="int8"),
    "int8+eq": dict(quantization="int8", equalize=0.5),
    "int4": dict(quantization="int4"),
    "int4+eq": dict(quantization="int4", equalize=0.5),
    "int4+eq+calib": dict(quantization="int4", equalize=0.5, calib=True),
}


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("quantization accuracy on trained weights")
    p.add_argument("--model", default="tae_patch16_vocab16_px256")
    p.add_argument("--ckpt", default=".convergence/torch/out/conv_checkpoint")
    p.add_argument("--val_data_path", default=".convergence/torch/data/val")
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--num_batches", default=4, type=int,
                   help="eval batches per mode (first N of the val loader)")
    p.add_argument("--calib_batches", default=2, type=int,
                   help="more val batches for the ln_amax calibration")
    p.add_argument("--modes", default=",".join(MODES),
                   help="comma list; bf16 always runs first")
    p.add_argument("--model_args", default="", type=str,
                   help='JSON config overrides, e.g. \'{"depth": 2}\'')
    p.add_argument("--device", default="cuda")
    p.add_argument("--out_json", default="",
                   help="also write the JSON line to this file")
    return p


def load_batches(val_data_path: str, input_size: int, batch_size: int,
                 want: int) -> list[np.ndarray]:
    """The first ``want`` full batches of the val loader (normalized fp32)."""
    from tae_tpu_torch.cli import _common

    loader = _common.imagefolder_val_loader(val_data_path, input_size,
                                            batch_size, num_workers=2)
    batches = []
    for imgs, _ in loader:
        if imgs.shape[0] == batch_size:
            batches.append(np.asarray(imgs))
        if len(batches) == want:
            break
    if len(batches) < want:
        raise SystemExit(f"val set too small: got {len(batches)} full "
                         f"batches, need {want}")
    return batches


def batch_metrics(tok, imgs: torch.Tensor, ref_z: torch.Tensor | None):
    """(fp32 latents, latent relative error against ``ref_z`` or None, MSE)
    of one batch, all on the device: the JAX script's ``fwd`` on
    ``tok.model`` (reference evaluate.py:92-96 metric space)."""
    model, pol = tok.model, tok.policy
    with torch.inference_mode():
        z = model.forward_encoder(imgs, policy=pol, backend=tok.backend)
        pred = model.forward_decoder(z, policy=pol, backend=tok.backend)
        target = model.patchify(imgs).float()
        mse = torch.mean(torch.square(pred.float() - target))
        z32 = z.float()
        rel = None
        if ref_z is not None:
            rel = torch.linalg.norm(z32 - ref_z) / torch.clamp(
                torch.linalg.norm(ref_z), min=1e-12)
    return z32, rel, mse


def evaluate_modes(model: str, ckpt: str | None, eval_batches, calib,
                   modes, device="cuda", each=None,
                   **overrides) -> dict[str, dict]:
    """``{mode: {"rel_err", "mse", "mse_delta_pct"}}`` for ``modes`` (bf16
    first), each a ``Tokenizer.from_checkpoint`` of ``model`` / ``ckpt`` on
    ``device``; ``eval_batches`` and ``calib`` are host image batches.
    ``each(mode, tokenizer)``, where given, runs after a mode's metrics,
    before its tokenizer is dropped."""
    from tae_tpu_torch.tokenizer import Tokenizer

    device = torch.device(device)
    modes = ["bf16"] + [m for m in modes if m != "bf16"]
    xs = [torch.from_numpy(np.asarray(b)).to(device) for b in eval_batches]
    results: dict[str, dict] = {}
    ref_latents: list[torch.Tensor] = []
    base_mse = None
    for name in modes:
        kw = dict(MODES[name])
        if kw.pop("calib", False):
            kw["calib_images"] = list(calib)
        tok = Tokenizer.from_checkpoint(model, ckpt or None, device=device,
                                        **kw, **overrides)
        rels, mses = [], []
        for i, imgs in enumerate(xs):
            ref = ref_latents[i] if name != "bf16" else None
            z32, rel, mse = batch_metrics(tok, imgs, ref)
            if name == "bf16":
                ref_latents.append(z32)
            else:
                rels.append(rel.item())
            mses.append(mse.item())
        r = {"rel_err": float(np.mean(rels)) if rels else 0.0,
             "mse": float(np.mean(mses))}
        if base_mse is None:
            base_mse = r["mse"]
        r["mse_delta_pct"] = 100.0 * (r["mse"] - base_mse) / base_mse
        results[name] = r
        print(f"[{name}] latent rel err {r['rel_err']:.4g}  "
              f"recon MSE {r['mse']:.6f}  ({r['mse_delta_pct']:+.2f}% vs "
              f"bf16)", flush=True)
        if each is not None:
            each(name, tok)
        del tok
    return results


def table(results: dict[str, dict]) -> str:
    lines = ["| mode | latent rel err vs bf16 | recon MSE | MSE vs bf16 |",
             "|---|---|---|---|"]
    for name, r in results.items():
        lines.append(f"| {name} | {r['rel_err']:.3g} | {r['mse']:.5f} | "
                     f"{r['mse_delta_pct']:+.2f}% |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> dict:
    from tae_tpu_torch.ckpt.io import checkpoint_step

    args = get_args_parser().parse_args(argv)
    step = checkpoint_step(args.ckpt) if args.ckpt else None
    print(f"checkpoint {args.ckpt or '(seeded init)'}: step {step}",
          flush=True)
    batches = load_batches(args.val_data_path, args.input_size,
                           args.batch_size,
                           args.num_batches + args.calib_batches)
    overrides = json.loads(args.model_args) if args.model_args else {}
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    results = evaluate_modes(args.model, args.ckpt,
                             batches[:args.num_batches],
                             batches[args.num_batches:], modes, args.device,
                             **overrides)
    print("\n" + table(results))
    line = json.dumps({"model": args.model, "ckpt": args.ckpt,
                       "checkpoint_step": step,
                       "images": args.batch_size * args.num_batches,
                       "results": results})
    print(line)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(line + "\n")
    print("DONE")
    return results


if __name__ == "__main__":
    main()
