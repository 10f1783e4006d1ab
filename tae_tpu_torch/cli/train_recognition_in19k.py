"""Latent-classifier pretraining on ImageNet-19k-style webdataset streams
(counterpart of ``tae_tpu/cli/train_recognition_in19k.py``).

The reference's semantics (reference recognition/train_recognition_in19k.py:
102-168): a frozen TAE encoder feeds latents to the recognition ViT; an
iteration-based infinite stream, plain cross-entropy, acc1 / acc5 train
metrics, a checkpoint (model and optimizer) and a JSONL row every
``--save_freq`` iterations. ``--latents_path`` trains from pre-encoded
latents (the encode driver's shards, or a reference-format ``.pth`` dump)
instead of images and the encoder.

The encoder is cast once to bf16, pruned to its encoder half and, with
``--encoder_quantization int8``, rewritten for int8 serving; it runs under
``torch.no_grad()`` (the JAX package's ``stop_gradient``) with the exact
softmax, as the JAX drivers call ``forward_encoder``. The reference's
two-GPU pipeline (encoder on one card, classifier on the other) is one card
here. Step metrics are read one step behind (:func:`_common.fetch_metrics`).

Run: ``python -m tae_tpu_torch.cli.train_recognition_in19k --model
vit_recognition_numpatches256_vocab256_base --num_classes 19167 --encoder
tae_patch16_vocab256_px256 --encoder_ckpt tae.pth --train_data_path
'shards-{000000..000099}.tar' ...`` (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path

import torch

from tae_tpu_torch.ckpt.io import load_train_state, save_checkpoint
from tae_tpu_torch.cli import _common
from tae_tpu_torch.data.loader import BatchLoader, device_prefetch
from tae_tpu_torch.data.transforms import maybe_device_normalize
from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
from tae_tpu_torch.train.losses import cross_entropy, topk_accuracy
from tae_tpu_torch.utils.dtypes import Policy
from tae_tpu_torch.utils.meters import MetricLogger, append_jsonl


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Downstream recognition pretraining (no eval)",
                                add_help=False)
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--save_prefix", default="", type=str)
    p.add_argument("--save_freq", default=10000, type=int)
    p.add_argument("--model", default="", type=str)
    p.add_argument("--model_ckpt", default="", type=str)
    p.add_argument("--num_classes", default=None, type=int)
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--encoder", default="", type=str)
    p.add_argument("--encoder_ckpt", default="", type=str)
    p.add_argument("--encoder_args", default="", type=str,
                   help="JSON overrides for the encoder factory")
    p.add_argument("--encoder_equalize", type=float, default=0.0,
                   help="SmoothQuant-style equalization alpha applied "
                        "before --encoder_quantization (0 = off)")
    p.add_argument("--encoder_quantization", default=None, choices=["int8"],
                   help="run the frozen encoder in the int8 w8a8 serving "
                        "layout")
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--max_lr", type=float, default=1e-4)
    p.add_argument("--min_lr", type=float, default=1e-5)
    p.add_argument("--switch_it", type=int, default=900000)
    p.add_argument("--num_its", type=int, default=1000001)
    p.add_argument("--train_data_path", default="", type=str)
    p.add_argument("--latents_path", default="", type=str,
                   help="train from pre-encoded latents instead of "
                        "images + frozen encoder: encode driver output "
                        "dir / index, or a reference-format "
                        "{latents, targets} .pth dump")
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--device_normalize", action="store_true",
                   help="ship uint8 pixels and normalize on the device (4x "
                        "smaller host-to-device copies; needs the native "
                        "decoder)")
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--log_freq", default=50, type=int)
    _common.add_device_args(p)
    return p


def _latent_iter(path: str, seed: int, worker_id: int, num_workers: int):
    from tae_tpu_torch.data.latents import LatentDataset

    ds = LatentDataset(path)
    yield from ds.iter_samples(worker_id, num_workers, loop=True,
                               seed=seed + worker_id)


def main(args) -> None:
    print(f"{args}".replace(", ", ",\n"))
    device = _common.device_of(args)
    policy = Policy()
    model = _common.build_model(args.model, model_args=args.model_args,
                                num_classes=args.num_classes, device=device,
                                trainable=True)
    model.init_weights_(torch.Generator(device=device).manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model: {args.model}; params (M): {n_params / 1e6}")

    from_latents = bool(args.latents_path)
    encoder = None if from_latents else _common.frozen_encoder(args, device)
    enc_policy = Policy(param_dtype=torch.bfloat16)

    opt = adamw(weight_decay=args.weight_decay)
    state = TrainState.create(model, opt)
    if args.model_ckpt:
        _, restored, _ = load_train_state(args.model_ckpt, model, state.opt)
        print(f"Resumed classifier {args.model_ckpt}"
              + (" with optimizer state" if restored else ""))

    def loss_fn(m, batch):
        x, targets = batch
        if from_latents:
            z = x
        else:
            # uint8 batches (--device_normalize) are normalized on the card
            x = maybe_device_normalize(x, encoder.cfg.patch_size,
                                       torch.float32)
            with torch.no_grad():
                z = encoder.forward_encoder(x, policy=enc_policy,
                                            backend=args.attn_backend)
        logits = m(z, policy=policy, backend=args.attn_backend,
                   remat=args.remat)
        return cross_entropy(logits, targets), topk_accuracy(logits, targets)

    step = make_train_step(loss_fn, opt,
                           step_lr(args.max_lr, args.min_lr, args.switch_it),
                           accum_iter=args.accum_iter)

    batch_size = args.batch_size * args.accum_iter
    if from_latents:
        loader = BatchLoader(functools.partial(_latent_iter, args.latents_path,
                                               args.seed),
                             batch_size, num_workers=args.num_workers,
                             drop_last=True)
    else:
        _common.print_decoder()
        loader = _common.wds_train_loader(args, batch_size)

    out_dir = Path(args.output_dir)
    stem = f"{args.save_prefix}_{args.model}"
    metric_logger = MetricLogger()

    def read(pit: int, fetched) -> None:
        vals = _common.host_metrics(fetched)
        _common.check_finite_loss(vals)
        metric_logger.update(loss=vals["loss"])
        metric_logger.update(n=args.batch_size, acc1=vals["acc1"],
                             acc5=vals["acc5"])
        if pit % args.log_freq == 0:
            print(f"it {pit}: {metric_logger}", flush=True)

    print("Starting training!")
    pending = None
    for it, batch in enumerate(device_prefetch(loader, device)):
        if it == args.num_its:
            break
        state, metrics = step(state, tuple(batch), it)
        fetched = _common.fetch_metrics(
            {k: metrics[k] for k in ("loss", "acc1", "acc5")})
        if pending is not None:
            read(*pending)          # step it - 1, while step it runs
        pending = (it, fetched)

        saving = it != 0 and it % args.save_freq == 0
        if saving or it == args.num_its - 1:
            read(*pending)
            pending = None
        if not saving:
            continue
        print(f"Iteration {it}")
        save_checkpoint(out_dir / f"{stem}_checkpoint", state, step=it,
                        args=dict(vars(args)))
        metric_logger.synchronize_between_processes()
        log_stats = {**{f"train_{k}": m.global_avg
                        for k, m in metric_logger.meters.items()},
                     "iteration": it}
        append_jsonl(out_dir / f"{stem}_log.txt", log_stats)
        metric_logger = MetricLogger()
    if pending is not None:         # the data ran out before num_its
        read(*pending)


def cli_main() -> None:
    args = get_args_parser().parse_args()
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == "__main__":
    cli_main()
