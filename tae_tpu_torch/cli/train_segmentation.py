"""Semantic-segmentation training on frozen TAE latents (counterpart of
``tae_tpu/cli/train_segmentation.py``).

The reference's semantics (reference segmentation/train.py): epoch-based
COCO (-> VOC-21) or VOC dense prediction with the ``out + 0.5 · aux``
cross-entropy criterion (ignore index 255, reference :49-57), a confusion
matrix / mean-IoU evaluation (:60-85), a checkpoint every epoch (:168-176)
with its ``mean_iou``, StepLR(90, 0.1) (:151), ``--resume`` continuing at
the saved epoch + 1, and head-swap transfer from an in1k-pretrained
checkpoint (:133-136, 156-157). The frozen encoder is the recognition
drivers' (bf16, pruned to its encoder half, optionally int8). Step metrics
are read one step behind.

Run: ``python -m tae_tpu_torch.cli.train_segmentation --dataset coco
--data_path coco/ --model vit_segmentation_numpatches256_vocab256_base
--encoder tae_patch16_vocab256_px256 --encoder_ckpt tae.pth ...``
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path

import numpy as np
import torch

from tae_tpu_torch.ckpt.io import load_train_state, save_checkpoint
from tae_tpu_torch.cli import _common
from tae_tpu_torch.data.coco_seg import load_dataset
from tae_tpu_torch.data.loader import BatchLoader, device_prefetch
from tae_tpu_torch.data.seg_transforms import SegEvalTransform, SegTrainTransform
from tae_tpu_torch.train import TrainState, adamw, epoch_step_lr, make_train_step
from tae_tpu_torch.utils.confusion import ConfusionMatrix
from tae_tpu_torch.utils.dtypes import Policy
from tae_tpu_torch.utils.meters import MetricLogger, append_jsonl


def get_args_parser(add_help: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Segmentation training on TAE latents",
                                add_help=add_help)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--dataset", default="coco", type=str,
                   choices=["coco", "voc", "voc_aug"])
    p.add_argument("--model", default="", type=str)
    p.add_argument("--model_ckpt", default="", type=str)
    p.add_argument("--pretrain_num_classes", default=1000, type=int)
    p.add_argument("--encoder", default="", type=str)
    p.add_argument("--encoder_ckpt", default="", type=str)
    p.add_argument("--encoder_args", default="", type=str)
    p.add_argument("--encoder_quantization", default=None, choices=["int8"],
                   help="run the frozen encoder in the int8 w8a8 serving "
                        "layout")
    p.add_argument("--aux_loss", action="store_true",
                   help="accepted for compatibility; the model always has an "
                        "aux head and the criterion always adds 0.5*aux")
    p.add_argument("--batch_size_per_gpu", default=8, type=int)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--workers", default=16, type=int)
    p.add_argument("--lr", default=0.01, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--world_size", default=1, type=int)
    _common.add_device_args(p)
    return p


def masked_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         ignore: int = 255) -> torch.Tensor:
    """Cross-entropy over (B, C, H, W) dense logits in fp32, the mean over
    the pixels whose target is not ``ignore``. Where every pixel is ignored
    the loss is 0, as the JAX criterion gives (``F.cross_entropy`` with
    ``ignore_index`` returns NaN there)."""
    lp = torch.log_softmax(logits.float(), dim=1)
    valid = target != ignore
    t = torch.where(valid, target, 0).long()
    picked = lp.gather(1, t[:, None]).squeeze(1)
    losses = torch.where(valid, -picked, 0.0)
    return losses.sum() / valid.sum().clamp_min(1)


def criterion(out: dict[str, torch.Tensor], target: torch.Tensor
              ) -> torch.Tensor:
    """out + 0.5 * aux (reference segmentation/train.py:49-57)."""
    return (masked_cross_entropy(out["out"], target)
            + 0.5 * masked_cross_entropy(out["aux"], target))


def _train_iter(args_tuple, worker_id: int, num_workers: int):
    dataset_name, data_path, input_size, seed = args_tuple
    ds, _ = load_dataset(dataset_name, data_path, "train")
    tf = SegTrainTransform(base_size=int(input_size * 288 / 256),
                           crop_size=input_size)
    rng = np.random.default_rng(seed + 101 * worker_id)
    order = rng.permutation(len(ds))
    for i in order[worker_id::num_workers]:
        img, mask = ds[int(i)]
        yield tf(img, mask, rng)


def main(args) -> None:
    print(f"{args}".replace(", ", ",\n"))
    device = _common.device_of(args)
    policy = Policy()

    _, num_classes = load_dataset(args.dataset, args.data_path, "val",
                                  transforms=None) if args.data_path else (None, 21)
    model = _common.build_downstream_model(args, device, num_classes)
    encoder = _common.frozen_encoder(args, device)
    enc_policy = Policy(param_dtype=torch.bfloat16)

    opt = adamw(weight_decay=args.weight_decay)
    state = TrainState.create(model, opt)
    start_epoch = args.start_epoch
    if args.resume:
        _, _, meta = load_train_state(args.resume, model, state.opt)
        start_epoch = int(meta.get("step", start_epoch - 1)) + 1
        print(f"Resumed {args.resume} at epoch {start_epoch}")

    def encode(imgs):
        with torch.no_grad():
            return encoder.forward_encoder(imgs, policy=enc_policy,
                                           backend=args.attn_backend)

    def loss_fn(m, batch):
        imgs, target = batch
        out = m(encode(imgs), policy=policy, backend=args.attn_backend,
                remat=args.remat)
        return criterion(out, target), {}

    step = make_train_step(loss_fn, opt, epoch_step_lr(args.lr, 90, 0.1))

    @torch.no_grad()
    def predict(imgs):
        out = model(encode(imgs), policy=policy, backend=args.attn_backend)
        return out["out"].argmax(dim=1)

    out_dir = Path(args.output_dir)
    for epoch in range(start_epoch, args.epochs):
        make_iter = functools.partial(
            _train_iter, (args.dataset, args.data_path, args.input_size,
                          args.seed + epoch))
        loader = BatchLoader(make_iter, args.batch_size_per_gpu,
                             num_workers=args.workers, drop_last=True)
        logger = MetricLogger()

        def read(pit: int, fetched) -> None:
            vals = _common.host_metrics(fetched)
            _common.check_finite_loss(vals)
            logger.update(**vals)
            if pit % args.print_freq == 0:
                print(f"Epoch: [{epoch}] [{pit}] {logger}", flush=True)

        pending = None
        for it, batch in enumerate(device_prefetch(loader, device)):
            state, metrics = step(state, tuple(batch), epoch)
            fetched = _common.fetch_metrics(
                {k: metrics[k] for k in ("loss", "lr")})
            if pending is not None:
                read(*pending)
            pending = (it, fetched)
        if pending is not None:
            read(*pending)

        confmat = evaluate(predict, args, num_classes, device)
        print(confmat)
        save_checkpoint(out_dir / "checkpoint", state, step=epoch,
                        args=dict(vars(args)),
                        extra={"mean_iou": confmat.mean_iou})
        append_jsonl(out_dir / "seg_log.txt",
                     {**{f"train_{k}": m.global_avg
                         for k, m in logger.meters.items()},
                      "mean_iou": confmat.mean_iou, "epoch": epoch})


def evaluate(predict, args, num_classes: int,
             device: torch.device) -> ConfusionMatrix:
    """The val split at ``--input_size`` (image bilinear, mask nearest)
    through ``predict``, in batches of ``--batch_size_per_gpu`` (a short
    last batch padded), into a confusion matrix."""
    ds, _ = load_dataset(args.dataset, args.data_path, "val",
                         transforms=SegEvalTransform(args.input_size))
    confmat = ConfusionMatrix(num_classes)
    bs = args.batch_size_per_gpu

    def val_iter(worker_id, num_workers):
        for i in range(len(ds)):
            yield ds[i]

    for imgs, target in BatchLoader(val_iter, bs):
        padded, n = _common.pad_batch(imgs, bs)
        pred = predict(torch.from_numpy(padded).to(device))[:n]
        confmat.update(torch.from_numpy(np.asarray(target)[:n]), pred)
    confmat.reduce_from_all_processes()
    return confmat


def cli_main() -> None:
    args = get_args_parser().parse_args()
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == "__main__":
    cli_main()
