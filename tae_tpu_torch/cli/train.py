"""TAE training driver (counterpart of ``tae_tpu/cli/train.py``).

The reference's training semantics (reference train.py:59-223): an
iteration-based infinite webdataset stream, the 2-level step LR, gradient
accumulation, an eval every ``save_freq`` iterations with best-eval-loss
checkpointing, JSONL logs, reconstruction grids and the non-finite-loss
abort, on the port's training surface: fp32 parameters, bf16 compute,
``make_train_step`` (forward, backward, AdamW in place; metrics as device
scalars), inputs copied to the card ahead of their step.

The metrics of step k are copied to pinned host memory right behind the
step and read after step k+1 has been queued, waiting on that copy's event
alone, so the host never holds the card idle to read them; a non-finite
loss stops the run one step later than the reference's per-step
``loss.item()`` does, and before any eval or checkpoint that follows it (at
an eval or the last iteration the step's own metrics are read first).

On one card the steps and the eval pass run from captured CUDA graphs (the
JAX driver's ``jax.jit`` of the step and of its eval function;
``make_train_step(cuda_graphs=)``, ``make_eval_fn``): an eager first step,
a capture on the second, replays after. ``--cuda_graphs off`` runs them
eagerly, ``on`` raises where graphs cannot run (the CPU, a sharded model);
the driver prints the mode.

Checkpoints: ``{prefix}_checkpoint_latest`` is written at every eval (the
newest state, for preemption), and promoted to ``{prefix}_checkpoint`` (the
reference's best-eval contract, train.py:164-172) when the eval loss
improves. ``--resume_auto`` continues from the newer of the two at its step
+ 1, with the optimizer state.

Under ``torchrun`` the model is placed on the ``(data, fsdp, tensor)`` mesh
(``parallel.shard_model``). The global batch is ``--batch_size_per_gpu`` x
``--accum_iter``, the JAX package's for the same flags: every rank reads the
same stream and keeps its rows of each batch, so a run on N processes sees
the images one process sees (each rank decodes the whole batch). Metrics
are averaged over the ranks; rank 0 writes the logs, checkpoints and grids.

Run: ``python -m tae_tpu_torch.cli.train --model tae_patch16_vocab256_px256
--train_data_path 'shards-{000000..000099}.tar' --val_data_path val/ ...``
(``--device cpu`` for the CPU; ``torchrun --nproc_per_node N -m
tae_tpu_torch.cli.train ... --mesh_fsdp F --mesh_tensor T`` for N
processes).
"""

from __future__ import annotations

import argparse
import collections
from pathlib import Path

import numpy as np
import torch

from tae_tpu_torch.ckpt.io import load_params, save_checkpoint
from tae_tpu_torch.cli import _common
from tae_tpu_torch.cli.evaluate import per_sample_loss_and_pred
from tae_tpu_torch.data.loader import device_prefetch
from tae_tpu_torch.parallel import batch_slice, is_main_process, shard_model
from tae_tpu_torch.serving_graphs import GraphPool
from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
from tae_tpu_torch.train.step import make_eval_fn
from tae_tpu_torch.utils.dtypes import Policy
from tae_tpu_torch.utils.image_grid import save_image
from tae_tpu_torch.utils.meters import MetricLogger, append_jsonl


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("TAE training with webdataset streams", add_help=False)
    p.add_argument("--batch_size_per_gpu", default=256, type=int,
                   help="global batch = batch_size_per_gpu * accum_iter")
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--save_prefix", default="", type=str)
    p.add_argument("--save_freq", default=10000, type=int)
    p.add_argument("--model", default="", type=str)
    p.add_argument("--ckpt", default="", help="load model weights from a "
                   "checkpoint (a port checkpoint or a reference .pth); "
                   "training restarts at iteration 0 (reference semantics)")
    p.add_argument("--resume_auto", action="store_true",
                   help="preemption-safe resume: restore params + optimizer "
                        "+ iteration from this run's own checkpoint if it "
                        "exists and continue where it left off")
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--display", action="store_true")
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--max_lr", type=float, default=1e-4)
    p.add_argument("--min_lr", type=float, default=1e-5)
    p.add_argument("--switch_it", type=int, default=900000)
    p.add_argument("--num_its", type=int, default=1000001)
    p.add_argument("--train_data_path", default="", type=str)
    p.add_argument("--val_data_path", default="", type=str)
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--jitter_scale", default=[0.2, 1.0], type=float, nargs="+")
    p.add_argument("--jitter_ratio", default=[3.0 / 4.0, 4.0 / 3.0], type=float,
                   nargs="+")
    p.add_argument("--log_freq", default=50, type=int,
                   help="print training metrics every N iterations")
    p.add_argument("--device_normalize", action="store_true",
                   help="ship uint8 pixels and normalize on the device (4x "
                        "smaller host-to-device copies; needs the native "
                        "decoder)")
    _common.add_device_args(p)
    return p


def main(args) -> None:
    print(f"{args}".replace(", ", ",\n"))
    mesh, device = _common.build_mesh(args)
    model = _common.build_model(args.model, model_args=args.model_args,
                                device=device, trainable=True)
    model.init_weights_(torch.Generator(device=device).manual_seed(args.seed))
    policy = Policy()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model: {args.model}; params (M): {n_params / 1e6}")

    opt = adamw(weight_decay=args.weight_decay)
    if args.ckpt:
        load_params(args.ckpt, model)
        print(f"Resumed checkpoint {args.ckpt}")
    model = shard_model(model, mesh)
    state = TrainState.create(model, opt)
    graphs = _common.graphs_mode(args, model)
    # one memory pool for the step's graphs and the eval pass's: their
    # replays never overlap
    pool = GraphPool()

    start_it = 0
    best_eval_loss = 100.0
    out_dir = Path(args.output_dir)
    best_path = out_dir / f"{args.save_prefix}_checkpoint"
    latest_path = out_dir / f"{args.save_prefix}_checkpoint_latest"
    if args.resume_auto:
        from tae_tpu_torch.ckpt.io import checkpoint_step, load_train_state

        resume_from = max((d for d in (best_path, latest_path)
                           if checkpoint_step(d) is not None),
                          key=checkpoint_step, default=None)
        if resume_from is not None:
            _, _, meta = load_train_state(resume_from, model, state.opt)
            start_it = int(meta.get("step", 0)) + 1
            best_eval_loss = float(meta.get("best_eval_loss", best_eval_loss))
            print(f"Auto-resumed {resume_from} at iteration {start_it} "
                  f"(best eval loss {best_eval_loss})")

    from tae_tpu_torch.data.transforms import maybe_device_normalize

    def loss_fn(m, imgs):
        # uint8 batches (--device_normalize) are normalized on the card
        imgs = maybe_device_normalize(imgs, m.cfg.patch_size, torch.float32)
        loss, _ = m(imgs, policy=policy, backend=args.attn_backend,
                    remat=args.remat)
        return loss, {}

    step = make_train_step(loss_fn, opt,
                           step_lr(args.max_lr, args.min_lr, args.switch_it),
                           accum_iter=args.accum_iter, cuda_graphs=graphs,
                           pool=pool)
    # the eval pass's per-sample losses, from a graph per batch shape, in
    # the step's memory pool
    eval_losses = make_eval_fn(
        lambda x: per_sample_loss_and_pred(model, x, policy,
                                           args.attn_backend)[0],
        model, graphs, pool=pool)

    _common.print_decoder()
    # this rank's rows from its own stream (the global batch over the ranks)
    train_loader = _common.wds_train_loader(
        args, args.batch_size_per_gpu * args.accum_iter, mesh)

    metric_logger = MetricLogger()
    display_samples = None

    def read(pit: int, fetched) -> None:
        """Step ``pit``'s metrics on the host; abort on a non-finite loss
        (reference train.py:152-155)."""
        vals = _common.host_metrics(fetched)
        _common.check_finite_loss(vals)
        metric_logger.update(**vals)
        if pit % args.log_freq == 0:
            print(f"it {pit}: {metric_logger}", flush=True)

    print("Starting TAE training!")
    pending = None
    batches = (imgs for imgs, _ in train_loader)
    for it, imgs in enumerate(device_prefetch(batches, device),
                              start=start_it):
        if it >= args.num_its:
            break
        if args.display and it % args.save_freq == 0:
            display_samples = imgs[:8].clone()

        state, metrics = step(state, imgs, it)
        fetched = _common.fetch_metrics(metrics, mesh)
        if pending is not None:
            read(*pending)          # step it - 1, while step it runs
        pending = (it, fetched)

        evaluating = it != 0 and it % args.save_freq == 0
        if evaluating or it == args.num_its - 1:
            read(*pending)
            pending = None
        if not evaluating:
            continue
        print(f"Iteration {it}, evaluating ...")
        eval_loss = evaluate(eval_losses, args, device, mesh)

        # the JSONL row first: the eval trajectory is the run's primary
        # artifact and must not wait behind a checkpoint save
        metric_logger.synchronize_between_processes(mesh)
        log_stats = {**{f"train_{k}": m.global_avg
                        for k, m in metric_logger.meters.items()},
                     "eval_loss": float(eval_loss), "iteration": it}
        if is_main_process():
            append_jsonl(out_dir / f"{args.save_prefix}_log.txt", log_stats)

        improved = eval_loss < best_eval_loss
        best_eval_loss = min(best_eval_loss, float(eval_loss))
        save_checkpoint(latest_path, state, step=it, args=dict(vars(args)),
                        extra={"best_eval_loss": best_eval_loss,
                               "eval_loss": float(eval_loss)})
        if improved:
            print("Best eval loss improved! Saving checkpoint.")
            from tae_tpu_torch.ckpt.io import promote_checkpoint

            promote_checkpoint(latest_path, best_path)

        if args.display and display_samples is not None:
            save_reconstructions(model, display_samples, policy,
                                 out_dir / f"{args.save_prefix}_"
                                 f"reconstructions_iter_{it}.jpg")
        metric_logger = MetricLogger()
    if pending is not None:         # the data ran out before num_its
        read(*pending)


def save_reconstructions(model, samples: torch.Tensor, policy: Policy,
                         path: Path) -> None:
    """Originals over reconstructions, as a grid of eight a row. Under a
    mesh every rank runs the forward (its parameters are gathered) and
    rank 0 writes."""
    from tae_tpu_torch.data.transforms import device_normalize

    with torch.no_grad():
        if samples.dtype == torch.uint8:
            samples = device_normalize(samples, torch.float32)
        _, pred = model(samples, policy=policy)
        recon = model.unpatchify(pred).float()
    if not is_main_process():
        return
    combined = np.concatenate([samples.cpu().numpy(), recon.cpu().numpy()],
                              axis=0)
    save_image(combined, path, nrow=8, padding=1)


def evaluate(per_sample, args, device: torch.device, mesh=None) -> float:
    """Full val pass; the mean of per-batch mean MSEs (reference
    train.py:203-223, the unequal final batch included). ``per_sample(x)``:
    the per-sample MSEs of a normalized batch on the card (the model's
    forward; from a CUDA graph where the run has them: every batch is
    padded to one shape, and the count of its real rows is read on the
    host, outside the graph). Under a mesh every rank reads the same
    batches and runs its rows; each batch's mean is taken over the real
    rows of all ranks."""
    eval_bs = 8 * args.batch_size_per_gpu
    loader = _common.imagefolder_val_loader(args.val_data_path, args.input_size,
                                            eval_bs, num_workers=args.num_workers)
    real_counts: collections.deque[int] = collections.deque()

    def padded_batches():
        for imgs, _ in loader:
            padded, n = _common.pad_batch(imgs, eval_bs)
            real_counts.append(n)
            yield padded

    losses = []
    with torch.no_grad():
        for imgs in device_prefetch(padded_batches(), device):
            per = per_sample(batch_slice(imgs, mesh))
            losses.append(_common.real_rows_mean(per, real_counts.popleft(),
                                                 mesh))
    eval_loss = float(np.mean(losses))
    print(f"Current eval loss: {eval_loss}")
    return eval_loss


def cli_main() -> None:
    args = get_args_parser().parse_args()
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == "__main__":
    cli_main()
