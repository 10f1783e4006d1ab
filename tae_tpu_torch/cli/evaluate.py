"""Reconstruction evaluation driver (counterpart of
``tae_tpu/cli/evaluate.py``).

Computes the full-val mean MSE, the mean of per-batch means (reference
evaluate.py:84-102), and the PSNR in [0, 1] pixel space, and optionally
writes an originals / reconstructions grid. ``--resume`` loads a checkpoint
(a port checkpoint or a reference-layout ``.pth``) through
``ckpt/io.load_params``. The model holds fp32 parameters and computes in
bf16 with the exact softmax, as the JAX driver does.

On one card each batch's forward runs from a captured CUDA graph (the JAX
driver's jitted eval function; every batch is padded to one shape):
``--cuda_graphs {auto,on,off}``, the mode printed.

Under ``torchrun`` the model is placed on the ``(data, fsdp, tensor)`` mesh; every
rank reads the same batches and runs its rows of each, and each batch's mean
is taken over the real rows of all ranks, so the loss is one process's.
Rank 0 writes the grid.

Run: ``python -m tae_tpu_torch.cli.evaluate --model tae_patch16_vocab256_px256
--resume ckpt.pth --val_data_path val/`` (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import collections
import functools
from pathlib import Path

import numpy as np
import torch

from tae_tpu_torch.cli import _common
from tae_tpu_torch.data.loader import device_prefetch
from tae_tpu_torch.data.transforms import IMAGENET_STD
from tae_tpu_torch.parallel import batch_slice, is_main_process, shard_model
from tae_tpu_torch.train.step import make_eval_fn
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
    mse_px = (sq * _psnr_weights(model.cfg.patch_size, imgs.device)).mean(
        dim=(1, 2))
    psnr = -10.0 * torch.log10(mse_px.clamp_min(1e-12))
    return per, psnr, pred


@functools.lru_cache(maxsize=None)
def _psnr_weights(patch_size: int, device: torch.device) -> torch.Tensor:
    """std_c² tiled p² times along a patch's (p, q, c) values, made once per
    device (a host-to-device copy, which a CUDA graph may not hold)."""
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    return (std * std).repeat(patch_size ** 2)


def main(args) -> float:
    print(f"{args}".replace(", ", ",\n"))
    mesh, device = _common.build_mesh(args)
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
    model = shard_model(model, mesh)
    graphs = _common.graphs_mode(args, model)
    # the per-sample values of a batch, from a graph per batch shape (every
    # batch is padded to one)
    per_sample = make_eval_fn(
        lambda x: per_sample_loss_and_pred(model, x, policy,
                                           args.attn_backend)[:2],
        model, graphs)

    # the reference's batch 8192 default does not fit the big configs;
    # clamp by a footprint estimate instead of running out of memory
    args.batch_size_per_gpu = _common.clamp_eval_batch(
        args.batch_size_per_gpu, model, device, mesh)

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
            per, psnr = per_sample(batch_slice(imgs, mesh))
            losses.append(_common.real_rows_mean(per, n, mesh))
            psnrs.append(_common.real_rows_mean(psnr, n, mesh))
        eval_loss = float(np.mean(losses))
        print(f"Eval loss: {eval_loss}")
        print(f"Eval PSNR: {float(np.mean(psnrs)):.2f} dB")

        if args.display and samples_for_display is not None:
            x = torch.from_numpy(samples_for_display).to(device)
            _, _, pred = per_sample_loss_and_pred(model, x, policy,
                                                  args.attn_backend)
            recon = model.unpatchify(pred).float().cpu().numpy()
        if args.display and samples_for_display is not None \
                and is_main_process():
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
