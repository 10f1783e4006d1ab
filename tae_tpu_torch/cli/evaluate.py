"""Reconstruction evaluation driver (counterpart of
``tae_tpu/cli/evaluate.py``).

Computes the full-val mean MSE, the mean of per-batch means (reference
evaluate.py:84-102), and the PSNR in [0, 1] pixel space, and optionally
writes an originals / reconstructions grid. ``--resume`` loads a checkpoint
(a port checkpoint or a reference-layout ``.pth``) through
``ckpt/io.load_params``. The model holds fp32 parameters and computes in
bf16 with the exact softmax, as the JAX driver does.

Run: ``python -m tae_tpu_torch.cli.evaluate --model tae_patch16_vocab256_px256
--resume ckpt.pth --val_data_path val/`` (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import collections
from pathlib import Path

import numpy as np
import torch

from tae_tpu_torch.cli import _common
from tae_tpu_torch.data.loader import device_prefetch
from tae_tpu_torch.data.transforms import IMAGENET_STD
from tae_tpu_torch.utils.dtypes import Policy
from tae_tpu_torch.utils.image_grid import save_image


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("TAE evaluation", add_help=False)
    p.add_argument("--batch_size_per_gpu", default=8192, type=int)
    p.add_argument("--save_prefix", default="", type=str)
    p.add_argument("--model", default="", type=str)
    p.add_argument("--resume", default="", help="checkpoint to evaluate")
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--display", action="store_true")
    p.add_argument("--val_data_path", default="", type=str)
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--num_workers", default=16, type=int)
    _common.add_device_args(p)
    return p


def per_sample_loss_and_pred(model, imgs: torch.Tensor, policy: Policy,
                             backend: str | None):
    """(per-sample MSE, per-sample PSNR, pred) of a normalized image batch,
    as the JAX driver computes them: the MSE in patch space in fp32; the
    PSNR in [0, 1] pixel space, each channel's squared error weighted by
    std_c² to undo the normalization (the patchify layout is (p, q, c), so
    the weights tile p² times along the last axis)."""
    z = model.forward_encoder(imgs, policy=policy, backend=backend)
    pred = model.forward_decoder(z, policy=policy, backend=backend)
    target = model.patchify(imgs).float()
    sq = (pred.float() - target).square()
    per = sq.mean(dim=(1, 2))
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=imgs.device)
    weights = (std * std).repeat(model.cfg.patch_size ** 2)
    mse_px = (sq * weights).mean(dim=(1, 2))
    psnr = -10.0 * torch.log10(mse_px.clamp_min(1e-12))
    return per, psnr, pred


def main(args) -> float:
    print(f"{args}".replace(", ", ",\n"))
    device = _common.device_of(args)
    model = _common.build_model(args.model, model_args=args.model_args,
                                device=device).eval()
    model.init_weights_(torch.Generator(device=device).manual_seed(args.seed))
    policy = Policy()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model: {args.model}; params (M): {n_params / 1e6}")

    if args.resume:
        from tae_tpu_torch.ckpt.io import load_params

        load_params(args.resume, model)
        print(f"Loaded checkpoint {args.resume}")

    # the reference's batch 8192 default does not fit the big configs;
    # clamp by a footprint estimate instead of running out of memory
    args.batch_size_per_gpu = _common.clamp_eval_batch(
        args.batch_size_per_gpu, model, device)

    _common.print_decoder()
    loader = _common.imagefolder_val_loader(args.val_data_path, args.input_size,
                                            args.batch_size_per_gpu,
                                            num_workers=args.num_workers)
    print("Starting TAE evaluation!")
    losses, psnrs = [], []
    samples_for_display = None
    real_counts: collections.deque[int] = collections.deque()

    def padded_batches():
        nonlocal samples_for_display
        for imgs, _ in loader:
            padded, n = _common.pad_batch(imgs, args.batch_size_per_gpu)
            if samples_for_display is None:
                samples_for_display = np.asarray(imgs[:min(8, n)])
            real_counts.append(n)
            yield padded

    with torch.no_grad():
        for imgs in device_prefetch(padded_batches(), device):
            n = real_counts.popleft()
            per, psnr, _ = per_sample_loss_and_pred(model, imgs, policy,
                                                    args.attn_backend)
            losses.append(float(per[:n].mean()))
            psnrs.append(float(psnr[:n].mean()))
        eval_loss = float(np.mean(losses))
        print(f"Eval loss: {eval_loss}")
        print(f"Eval PSNR: {float(np.mean(psnrs)):.2f} dB")

        if args.display and samples_for_display is not None:
            x = torch.from_numpy(samples_for_display).to(device)
            _, _, pred = per_sample_loss_and_pred(model, x, policy,
                                                  args.attn_backend)
            recon = model.unpatchify(pred).float().cpu().numpy()
            combined = np.concatenate([samples_for_display, recon], axis=0)
            out = (Path(args.output_dir)
                   / f"{args.save_prefix}_sample_reconstructions.jpg")
            save_image(combined, out, nrow=8, padding=1)
            print(f"Wrote {out}")
    return eval_loss


def cli_main() -> None:
    args = get_args_parser().parse_args()
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == "__main__":
    cli_main()
