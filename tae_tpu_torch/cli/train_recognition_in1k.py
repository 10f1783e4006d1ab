"""ImageNet-1k latent-classifier fine-tune with eval (counterpart of
``tae_tpu/cli/train_recognition_in1k.py``).

The reference's semantics (reference recognition/train_recognition_in1k.py):
epoch-based training on an ImageFolder with RandomResizedCrop (bilinear) +
RandAugment workers and the MixUp / CutMix collate, label-smoothed (0.1)
cross-entropy, StepLR(90, 0.1), head-swap transfer from an in19k checkpoint
(built with ``--pretrain_num_classes``, loaded, the head replaced, reference
:103-128), an acc1 / acc5 eval each epoch, and a checkpoint written when
the best eval acc1 improves (reference :173-184). The frozen encoder is
``train_recognition_in19k``'s. Step metrics are read one step behind.
Under ``torchrun`` the model is placed on the ``(data, fsdp, tensor)`` mesh
(the float encoder's blocks split over ``tensor``, an int8 one whole on
every rank), every rank reads the same batches and keeps
its rows, the eval's counts are summed over the ranks, and rank 0 writes
the logs.

On one card each step (mixup's soft targets a static input of its graph)
and each eval batch run from captured CUDA graphs (the JAX driver's jitted
step and eval step); ``--cuda_graphs off`` runs them eagerly, ``on`` raises
where graphs cannot run; the mode is printed.

Run: ``python -m tae_tpu_torch.cli.train_recognition_in1k --model
vit_recognition_numpatches256_vocab256_base --model_ckpt in19k_checkpoint
--encoder tae_patch16_vocab256_px256 --train_data_path train/
--val_data_path val/ ...`` (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path

import numpy as np
import torch

from tae_tpu_torch.ckpt.io import save_checkpoint
from tae_tpu_torch.cli import _common
from tae_tpu_torch.data.loader import BatchLoader, device_prefetch
from tae_tpu_torch.data.mixup import mixup_cutmix_collate
from tae_tpu_torch.data.randaugment import rand_augment
from tae_tpu_torch.data.transforms import random_resized_crop_transform
from tae_tpu_torch.parallel import is_main_process, shard_model
from tae_tpu_torch.serving_graphs import GraphPool
from tae_tpu_torch.train import TrainState, adamw, epoch_step_lr, make_train_step
from tae_tpu_torch.train.step import make_eval_fn
from tae_tpu_torch.train.losses import cross_entropy, topk_accuracy
from tae_tpu_torch.utils.dtypes import Policy
from tae_tpu_torch.utils.meters import MetricLogger, append_jsonl


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Downstream recognition fine-tune with eval",
                                add_help=False)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--save_prefix", default="", type=str)
    p.add_argument("--model", default="", type=str)
    p.add_argument("--model_ckpt", default="", type=str,
                   help="in19k-pretrained checkpoint; triggers head swap")
    p.add_argument("--pretrain_num_classes", default=19167, type=int,
                   help="class count the pretrained checkpoint was built with")
    p.add_argument("--num_classes", default=1000, type=int)
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--encoder", default="", type=str)
    p.add_argument("--encoder_ckpt", default="", type=str)
    p.add_argument("--encoder_args", default="", type=str)
    p.add_argument("--encoder_equalize", type=float, default=0.0,
                   help="SmoothQuant-style equalization alpha applied "
                        "before --encoder_quantization (0 = off)")
    p.add_argument("--encoder_quantization", default=None, choices=["int8"],
                   help="run the frozen encoder in the int8 w8a8 serving "
                        "layout")
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train_data_path", default="", type=str)
    p.add_argument("--val_data_path", default="", type=str)
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--log_freq", default=50, type=int)
    _common.add_device_args(p)
    return p


def _train_iter(root: str, input_size: int, seed: int, worker_id: int,
                num_workers: int):
    from PIL import Image

    from tae_tpu_torch.data.imagefolder import ImageFolder

    rng = np.random.default_rng(seed + 31 * worker_id)
    tf = random_resized_crop_transform(input_size, interpolation="bilinear",
                                       post=functools.partial(rand_augment))
    ds = ImageFolder(root)
    order = rng.permutation(len(ds.samples))
    for i in order[worker_id::num_workers]:
        path, target = ds.samples[int(i)]
        img = Image.open(path).convert("RGB")
        yield tf(img, rng), np.int64(target)


def main(args) -> None:
    print(f"{args}".replace(", ", ",\n"))
    mesh, device = _common.build_mesh(args)
    policy = Policy()
    model = _common.build_downstream_model(args, device, args.num_classes)
    encoder = _common.frozen_encoder(args, device, mesh)
    enc_policy = Policy(param_dtype=torch.bfloat16)

    opt = adamw(weight_decay=args.weight_decay)
    model = shard_model(model, mesh)
    state = TrainState.create(model, opt)
    graphs = _common.graphs_mode(args, model)
    pool = GraphPool()      # the step's graphs and the eval's share one

    def encode(imgs):
        with torch.no_grad():
            return encoder.forward_encoder(imgs, policy=enc_policy,
                                           backend=args.attn_backend)

    def loss_fn(m, batch):
        imgs, soft_targets = batch
        logits = m(encode(imgs), policy=policy, backend=args.attn_backend,
                   remat=args.remat)
        loss = cross_entropy(logits, soft_targets, label_smoothing=0.1)
        return loss, topk_accuracy(logits, soft_targets)

    # mixup's soft targets are one of the step graph's static inputs
    step = make_train_step(loss_fn, opt, epoch_step_lr(args.lr, 90, 0.1),
                           accum_iter=args.accum_iter, cuda_graphs=graphs,
                           pool=pool)

    def eval_logits(imgs, targets):
        logits = model(encode(imgs), policy=policy, backend=args.attn_backend)
        return cross_entropy(logits, targets), logits

    eval_step = make_eval_fn(eval_logits, model, graphs, pool=pool)

    collate = mixup_cutmix_collate(args.num_classes, seed=args.seed)
    _common.print_decoder()
    out_dir = Path(args.output_dir)
    stem = f"{args.save_prefix}_{args.model}"
    best_eval_acc1 = 0.0
    print("Starting training!")
    for epoch in range(args.epochs):
        make_iter = functools.partial(_train_iter, args.train_data_path,
                                      args.input_size, args.seed + epoch)
        loader = BatchLoader(make_iter, args.batch_size * args.accum_iter,
                             num_workers=args.num_workers, drop_last=True)
        metric_logger = MetricLogger()

        def read(pit: int, fetched) -> None:
            vals = _common.host_metrics(fetched)
            _common.check_finite_loss(vals)
            metric_logger.update(**vals)
            if pit % args.log_freq == 0:
                print(f"ep {epoch} it {pit}: {metric_logger}", flush=True)

        pending = None
        batches = _common.rank_batches(map(collate, loader), mesh)
        for it, batch in enumerate(device_prefetch(batches, device)):
            state, metrics = step(state, tuple(batch), epoch)
            fetched = _common.fetch_metrics(
                {k: metrics[k] for k in ("loss", "lr")}, mesh)
            if pending is not None:
                read(*pending)
            pending = (it, fetched)
        if pending is not None:
            read(*pending)

        print(f"Epoch {epoch}, evaluating ...")
        test_stats = evaluate(eval_step, args, device, mesh)
        if test_stats["acc1"] > best_eval_acc1:
            print("Best eval accuracy improved! Saving checkpoint.")
            save_checkpoint(out_dir / f"{stem}_checkpoint", state, step=epoch,
                            args=dict(vars(args)),
                            extra={"best_eval_acc1": float(test_stats["acc1"])})
            best_eval_acc1 = test_stats["acc1"]

        metric_logger.synchronize_between_processes(mesh)
        log_stats = {**{f"train_{k}": m.global_avg
                        for k, m in metric_logger.meters.items()},
                     **{f"test_{k}": v for k, v in test_stats.items()},
                     "epoch": epoch}
        if is_main_process():
            append_jsonl(out_dir / f"{stem}_log.txt", log_stats)


def evaluate(eval_step, args, device: torch.device,
             mesh=None) -> dict[str, float]:
    """Per-epoch eval: sample-weighted acc1 / acc5 and the mean of the
    batches' losses (reference :209-244). A short last batch is padded to
    the batch size (its loss, as the JAX package's, over the padded batch).
    Under a mesh every rank reads the same batches, runs its rows and
    counts its real ones; the meters are summed over the ranks."""
    from tae_tpu_torch.parallel import batch_slice
    from tae_tpu_torch.parallel.sharding import data_rank

    index, _ = data_rank(mesh)
    loader = _common.imagefolder_val_loader(args.val_data_path, args.input_size,
                                            args.batch_size, num_workers=0)
    logger = MetricLogger()
    for imgs, targets in loader:
        padded, n = _common.pad_batch(imgs, args.batch_size)
        tpad, _ = _common.pad_batch(np.asarray(targets), args.batch_size)
        padded, tpad = batch_slice(padded, mesh), batch_slice(tpad, mesh)
        loss, logits = eval_step(torch.from_numpy(padded).to(device),
                                 torch.from_numpy(tpad).to(device))
        first = index * len(padded)
        n = max(0, min(len(padded), n - first))     # this rank's real rows
        logits = logits[:n].float().cpu().numpy()
        t = tpad[:n]
        top5 = np.argsort(-logits, axis=-1)[:, :5]
        acc1 = 100.0 * float(np.mean(top5[:, 0] == t)) if n else 0.0
        acc5 = (100.0 * float(np.mean(np.any(top5 == t[:, None], axis=-1)))
                if n else 0.0)
        logger.update(loss=float(loss))
        logger.update(n=n, acc1=acc1, acc5=acc5)
    logger.synchronize_between_processes(mesh)
    stats = logger.global_avgs()
    print(f"* Acc@1 {stats.get('acc1', 0):.3f} Acc@5 {stats.get('acc5', 0):.3f} "
          f"loss {stats.get('loss', 0):.3f}")
    return stats


def cli_main() -> None:
    args = get_args_parser().parse_args()
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == "__main__":
    cli_main()
