"""Shared driver plumbing: argument groups, model and dataset construction
(counterpart of the host half of ``tae_tpu/cli/_common.py``).

Flag names stay those of the JAX package's drivers (and the reference's),
so a launch script ports with a module-name change. ``--device`` places the
run (``cuda`` by default; ``--device cpu`` runs the plain PyTorch versions,
as the tests do). Under ``torchrun`` (``WORLD_SIZE`` set) :func:`build_mesh`
joins the process group and builds the ``(data, fsdp, tensor)`` mesh that
``--mesh_fsdp`` and ``--mesh_tensor`` ask for; the drivers shard the model
on it (``parallel.shard_model``: each block split over ``tensor``, FSDP2
over ``data`` × ``fsdp``) and give each ``data`` × ``fsdp`` rank its rows
of every global batch (tensor peers take the same rows).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys

import numpy as np
import torch

from tae_tpu_torch import models
from tae_tpu_torch.data.loader import BatchLoader
from tae_tpu_torch.data.tar_stream import (ShardSpec, WebDatasetReader,
                                           decode_jpg_cls)
from tae_tpu_torch.data.transforms import (center_crop_transform,
                                           random_resized_crop_transform)


def add_device_args(parser: argparse.ArgumentParser) -> None:
    """The JAX package's ``add_tpu_args``, flag for flag."""
    g = parser.add_argument_group("device")
    g.add_argument("--mesh_fsdp", default=1, type=int,
                   help="fsdp mesh axis size (parameter sharding, FSDP2); "
                        "the data axis takes the other processes")
    g.add_argument("--mesh_tensor", default=1, type=int,
                   help="tensor mesh axis size (each block's attention "
                        "heads and MLP split over it, Megatron style)")
    g.add_argument("--remat", action="store_true",
                   help="recompute block activations in the backward pass")
    g.add_argument("--attn_backend", default=None,
                   choices=[None, "kernel", "reference"],
                   help="kernel: the hand-written CUDA kernels; reference: "
                        "the plain PyTorch versions (default: by device)")
    g.add_argument("--seed", default=0, type=int, help="parameter init seed")
    g.add_argument("--compile", action="store_true",
                   help="accepted for reference-script compatibility")
    g.add_argument("--device", default="cuda",
                   help="torch device the run is placed on (cuda, or cpu)")
    g.add_argument("--dist_url", default="env://",
                   help="init_method of the process group when WORLD_SIZE "
                        "is set (torchrun's env://, or file:// / tcp://)")
    g.add_argument("--model_args", default="", type=str,
                   help="JSON dict of config overrides for the model factory "
                        "(e.g. '{\"embed_dim\": 64}'; used by tests/smoke runs)")
    g.add_argument("--cuda_graphs", default="auto",
                   choices=["auto", "on", "off"],
                   help="run the train and eval steps (encode: the "
                        "Tokenizer's requests) from captured CUDA graphs, "
                        "the counterpart of the JAX drivers' jit; auto: on "
                        "one CUDA device for a model that is not sharded, "
                        "on: the same or raise, off: eager")


def cuda_graphs_flag(args) -> bool | None:
    """``--cuda_graphs`` as the library takes it: None (auto), True, False."""
    return {"auto": None, "on": True, "off": False}[
        getattr(args, "cuda_graphs", "auto")]


def graphs_mode(args, model) -> bool:
    """Whether ``model``'s steps run from CUDA graphs under
    ``--cuda_graphs`` (``train.step.step_graphs_mode``: ``on`` raises on
    the CPU and on a sharded model); printed as the drivers print it."""
    from tae_tpu_torch.train.step import step_graphs_mode

    try:
        on = step_graphs_mode(cuda_graphs_flag(args), model)
    except ValueError as e:
        raise SystemExit(f"--cuda_graphs on: {e}") from e
    print(f"cuda graphs: {'on' if on else 'off'}", flush=True)
    return on


def build_mesh(args):
    """``(mesh, device)`` of the run. Where ``WORLD_SIZE`` is set (torchrun)
    this joins the process group (``--dist_url``; NCCL on ``cuda``, gloo on
    ``cpu``) and builds the ``(data=-1, fsdp=--mesh_fsdp,
    tensor=--mesh_tensor)`` mesh; the device is ``cuda:LOCAL_RANK`` or the
    CPU. Without it the run is a world of 1: no mesh, ``--device`` as
    given. ``--mesh_fsdp`` × ``--mesh_tensor`` must divide the world, as
    the JAX ``make_mesh`` requires."""
    from tae_tpu_torch.parallel import mesh as pmesh
    from tae_tpu_torch.parallel.sharding import axis_sizes

    fsdp, tensor = getattr(args, "mesh_fsdp", 1), getattr(args, "mesh_tensor", 1)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    try:
        pmesh.mesh_sizes(world, -1, fsdp, tensor)
    except ValueError as e:
        raise SystemExit(f"--mesh_fsdp {fsdp} --mesh_tensor {tensor}: {e}")
    device = torch.device(args.device)
    if "WORLD_SIZE" not in os.environ:
        return None, device
    device = pmesh.initialize_distributed(init_method=args.dist_url,
                                          device_type=device.type)
    mesh = pmesh.make_mesh(-1, fsdp, tensor, device_type=device.type)
    print(f"mesh: {axis_sizes(mesh)} over {world} processes, rank "
          f"{pmesh.rank()} on {device}", flush=True)
    return mesh, device


def build_model(name: str, model_args: str = "", **kwargs):
    if model_args:
        kwargs = {**json.loads(model_args), **kwargs}
    return models.create(name, **kwargs)


def build_downstream_model(args, device: torch.device, num_classes: int):
    """A downstream driver's model (``--model``, ``--model_args``) at
    ``num_classes``, initialised from seed ``--seed``, or, with
    ``--model_ckpt``, built at ``--pretrain_num_classes``, loaded and given
    a fresh head for ``num_classes`` (head-swap transfer; the new head drawn
    from seed ``--seed`` + 2). Every parameter trainable."""
    build = num_classes if not args.model_ckpt else args.pretrain_num_classes
    model = build_model(args.model, model_args=args.model_args,
                        num_classes=build, device=device, trainable=True)
    model.init_weights_(torch.Generator(device=device).manual_seed(args.seed))
    if args.model_ckpt:
        from tae_tpu_torch.ckpt.io import load_params

        load_params(args.model_ckpt, model)
        model.replace_head(num_classes, torch.Generator(
            device=device).manual_seed(args.seed + 2))
        print(f"Loaded {args.model_ckpt} and swapped the head to "
              f"{num_classes} classes")
    return model


def maybe_quantize_encoder(model, mode: str | None, equalize: float = 0.0):
    """A frozen encoder stage is pure inference: ``mode == "int8"`` rewrites
    it in place to the w8a8 serving layout (``ops/int8.prepare_serving_``),
    after the SmoothQuant-style equalization when ``equalize`` > 0 (the
    alpha). The JAX package's checks, in its order."""
    if mode is None:
        if equalize:
            raise ValueError("--encoder_equalize requires "
                             "--encoder_quantization int8")
        return model
    if mode != "int8":
        raise ValueError(f"unknown encoder quantization {mode!r}")
    from tae_tpu_torch.ops.int8 import prepare_serving_

    return prepare_serving_(model, mode, equalize)


def frozen_encoder(args, device: torch.device, mesh=None):
    """The downstream drivers' frozen TAE encoder: ``--encoder`` built on
    ``device``, initialised from seed ``--seed`` + 1, ``--encoder_ckpt``
    loaded, cast once to bf16, pruned to its encoder half (the stage only
    ever runs ``forward_encoder``) and, with ``--encoder_quantization
    int8``, rewritten for int8 serving. Every parameter frozen. On a mesh a
    float encoder's blocks split over ``tensor``
    (``parallel.tensor.split_model_``; every rank then runs the same
    encoder calls); an int8 one stays whole on every rank."""
    from tae_tpu_torch.ckpt.io import load_params
    from tae_tpu_torch.tokenizer import prune_component

    encoder = build_model(args.encoder, model_args=args.encoder_args,
                          device=device)
    encoder.init_weights_(torch.Generator(device=device).manual_seed(
        args.seed + 1))
    n_params = sum(p.numel() for p in encoder.parameters())
    print(f"Encoder: {args.encoder}; params (M): {n_params / 1e6}")
    if args.encoder_ckpt:
        load_params(args.encoder_ckpt, encoder)
        print(f"Loaded encoder {args.encoder_ckpt}")
    encoder = prune_component(encoder.to(torch.bfloat16).eval(), "encoder")
    maybe_quantize_encoder(encoder, args.encoder_quantization,
                           getattr(args, "encoder_equalize", 0.0))
    encoder.requires_grad_(False)
    if args.encoder_quantization is None:
        from tae_tpu_torch.parallel.tensor import split_model_

        split_model_(encoder, mesh)
    return encoder


def fetch_metrics(metrics: dict, mesh=None):
    """Start copying a step's metrics (0-dim tensors) to the host: one
    stacked tensor, copied ``non_blocking`` into pinned memory right behind
    the step, and an event after the copy. :func:`host_metrics` waits on that
    event alone, so reading step k after step k+1 was queued does not wait
    for step k+1. Under CUDA graphs the metrics are copies of the graph's
    (``make_train_step``), and the stream orders this copy before the next
    replay, which writes the graph's own again. On a mesh the values are first averaged over the ranks
    (each rank's loss is the mean of its rows, so the average is the global
    batch's), every rank reading the same numbers."""
    names = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in names])
    vals = mean_over_ranks(vals, mesh)
    if not vals.is_cuda:
        return names, vals, None
    host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return names, host, done


def mean_over_ranks(vals: torch.Tensor, mesh) -> torch.Tensor:
    """``vals`` averaged over the (data, fsdp) ranks of ``mesh`` (the
    tensor itself without one), each counted once: tensor peers hold the
    same rows, and only tensor rank 0's values enter the sum."""
    from tae_tpu_torch.parallel.mesh import tensor_rank
    from tae_tpu_torch.parallel.sharding import data_rank

    _, count = data_rank(mesh)
    if count == 1:
        return vals
    import torch.distributed as dist

    vals = vals.clone() if tensor_rank(mesh) == 0 else torch.zeros_like(vals)
    dist.all_reduce(vals)
    return vals / count


def rank_batches(batches, mesh):
    """This rank's rows of each global batch (a tuple of arrays)."""
    from tae_tpu_torch.parallel.sharding import batch_slice

    for batch in batches:
        yield tuple(batch_slice(x, mesh) for x in batch)


def real_rows_mean(per: torch.Tensor, n: int, mesh) -> float:
    """The mean of the first ``n`` rows of a padded global batch, from
    ``per``, this rank's rows of it (per-sample values; all of them without
    a mesh), summed over the ranks."""
    from tae_tpu_torch.parallel.mesh import all_reduce_sum
    from tae_tpu_torch.parallel.sharding import data_rank

    index, count = data_rank(mesh)
    if count == 1:
        return float(per[:n].mean())
    first = index * per.shape[0]
    mine = per[:max(0, min(per.shape[0], n - first))]
    return float(all_reduce_sum([float(mine.double().sum())], mesh)[0]) / n


def host_metrics(fetched) -> dict[str, float]:
    names, host, done = fetched
    if done is not None:
        done.synchronize()
    return dict(zip(names, host.tolist()))


def check_finite_loss(vals: dict[str, float]) -> None:
    """The reference's non-finite-loss abort (train.py:152-155): exit 1."""
    if not math.isfinite(vals["loss"]):
        print(f"Loss is {vals['loss']}, stopping training", flush=True)
        sys.exit(1)


def print_decoder() -> None:
    """One line naming the JPEG decoder the run's input pipeline uses."""
    from tae_tpu_torch.data import native

    print(f"decoder: {native.decoder_name()}", flush=True)


# ---------------------------------------------------------------------------
# dataset builders (picklable worker factories for BatchLoader)
# ---------------------------------------------------------------------------

def decode_threads(num_workers: int) -> int:
    """Threads of the native decoder's pool in a loader of ``num_workers``
    worker processes: each worker decodes on one core; the inline
    (0-worker) loader, and a single worker, fan the pool across all cores
    (0: as many threads as cores)."""
    return 0 if num_workers <= 1 else 1


def _sample_cls(sample: dict) -> int:
    cls = sample.get("cls", b"-1")
    return int(cls.decode()) if isinstance(cls, bytes) else int(cls)


def _wds_train_iter(path: str, input_size: int, jitter_scale, jitter_ratio,
                    seed: int, process_index: int, process_count: int,
                    worker_id: int, num_workers: int):
    """Per-sample PIL train path (the native decoder is not built)."""
    spec = ShardSpec.from_string(path, resampled=True,
                                 seed=seed + 1000 * process_index + worker_id)
    reader = WebDatasetReader(
        spec, decode=None, shuffle_buffer=10_000,
        shard_index=process_index * num_workers + worker_id,
        shard_count=process_count * num_workers)
    rng = np.random.default_rng(seed + 7919 * (process_index * num_workers + worker_id))
    tf = random_resized_crop_transform(input_size, scale=tuple(jitter_scale),
                                       ratio=tuple(jitter_ratio))
    for sample in reader:
        try:
            img, _ = decode_jpg_cls(sample)
            arr = tf(img, rng)
        except (ValueError, KeyError, OSError):
            continue
        yield arr, np.int32(_sample_cls(sample))


def _wds_train_iter_batched(path: str, input_size: int, jitter_scale,
                            jitter_ratio, seed: int, process_index: int,
                            process_count: int, batch_size: int, u8: bool,
                            worker_id: int, num_workers: int):
    """Prebatched native train path: raw tar bytes -> the fused C++
    ``decode_batch`` straight into the batch buffer (no per-sample arrays,
    no ``np.stack`` collate). The same stream as :func:`_wds_train_iter`
    (resampled, shuffled, torchvision's crop boxes and flips); always yields
    whole batches, topping up from the stream when an image fails to
    decode."""
    from tae_tpu_torch.data import native
    from tae_tpu_torch.data.transforms import _sample_rrc_box

    scale, ratio = tuple(jitter_scale), tuple(jitter_ratio)
    spec = ShardSpec.from_string(path, resampled=True,
                                 seed=seed + 1000 * process_index + worker_id)
    reader = WebDatasetReader(
        spec, decode=None, shuffle_buffer=10_000,
        shard_index=process_index * num_workers + worker_id,
        shard_count=process_count * num_workers)
    rng = np.random.default_rng(
        seed + 7919 * (process_index * num_workers + worker_id))
    threads = decode_threads(num_workers)
    it = iter(reader)
    carry_imgs: list[np.ndarray] = []
    carry_cls: list[np.ndarray] = []
    carry_n = 0
    while True:
        need = batch_size - carry_n
        datas: list[bytes] = []
        clss: list[int] = []
        boxes = np.empty((need, 4), np.float32)
        flips = np.zeros((need,), np.int32)
        while len(datas) < need:
            sample = next(it)
            if "jpg" not in sample:
                continue
            data = bytes(sample["jpg"])
            try:
                w, h = native.jpeg_size(data)
            except ValueError:
                continue
            i = len(datas)
            top, left, bh, bw = _sample_rrc_box(rng, w, h, scale, ratio)
            boxes[i] = (left, top, left + bw, top + bh)
            flips[i] = rng.random() < 0.5
            datas.append(data)
            clss.append(_sample_cls(sample))
        decode = native.decode_batch_u8 if u8 else native.decode_batch
        imgs, keep = decode(datas, boxes, flips, input_size,
                            threads=threads, skip_failed=True)
        cls_arr = np.asarray(clss, np.int32)
        if keep is not None:
            cls_arr = cls_arr[keep]
        carry_imgs.append(imgs)
        carry_cls.append(cls_arr)
        carry_n += len(imgs)
        if carry_n < batch_size:
            continue  # rare decode failures: top up from the stream
        if len(carry_imgs) == 1:
            out = (carry_imgs[0], carry_cls[0])
            carry_imgs, carry_cls, carry_n = [], [], 0
        else:
            all_i = np.concatenate(carry_imgs)
            all_c = np.concatenate(carry_cls)
            out = (all_i[:batch_size], all_c[:batch_size])
            carry_imgs = [all_i[batch_size:]] if carry_n > batch_size else []
            carry_cls = [all_c[batch_size:]] if carry_n > batch_size else []
            carry_n -= batch_size
        yield out


def wds_train_loader(args, batch_size: int, mesh=None) -> BatchLoader:
    """The reference train pipeline (train.py:84-85): a resampled infinite
    stream, a 10k shuffle, RandomResizedCrop / flip / normalize. The native
    prebatched decode where the decoder is built, else PIL per sample; says
    which.

    Each of the (data, fsdp) ranks of ``mesh`` streams its own shards with
    its own seeds, as each process of the JAX drivers does (its index and
    count where they pass ``jax.process_index()``, ``process_count()``),
    and yields its own rows alone: ``batch_size``, the global batch, over
    the ranks. Tensor peers share a (data, fsdp) rank, so they stream the
    same shards and seeds and yield the same rows."""
    from tae_tpu_torch.data import native
    from tae_tpu_torch.parallel.sharding import data_rank

    rank, ranks = data_rank(mesh)
    if batch_size % ranks:
        raise ValueError(f"global batch {batch_size} does not divide over "
                         f"{ranks} data x fsdp ranks")
    rows = batch_size // ranks
    u8 = bool(getattr(args, "device_normalize", False))
    scale = getattr(args, "jitter_scale", [0.2, 1.0])
    ratio = getattr(args, "jitter_ratio", [3 / 4, 4 / 3])
    if native.available():
        print(f"Input pipeline: native prebatched decode "
              f"({args.num_workers} workers, no collate copy"
              + (", uint8 H2D + on-device normalize" if u8 else "") + ")",
              flush=True)
        make_iter = functools.partial(
            _wds_train_iter_batched, args.train_data_path, args.input_size,
            scale, ratio, args.seed, rank, ranks, rows, u8)
        return BatchLoader(make_iter, rows, num_workers=args.num_workers,
                           prebatched=True)
    if u8:
        print("WARNING: --device_normalize needs the native decoder "
              "(native/taedata.cpp, built at first use); shipping "
              "normalized f32 instead", flush=True)
    print("WARNING: input pipeline on the per-sample PIL + np.stack "
          "collate path (the native decoder needs g++ and libjpeg)",
          flush=True)
    make_iter = functools.partial(
        _wds_train_iter, args.train_data_path, args.input_size, scale, ratio,
        args.seed, rank, ranks)
    return BatchLoader(make_iter, rows, num_workers=args.num_workers)


def _imagefolder_val_iter(root: str, input_size: int, use_native: bool,
                          worker_id: int, num_workers: int):
    from tae_tpu_torch.data import native
    from tae_tpu_torch.data.imagefolder import ImageFolder

    if use_native:
        # fused C++ decode for JPEGs; PIL per file for other formats
        ds = ImageFolder(root)
        tf = center_crop_transform(input_size, pad=32)
        for i in range(worker_id, len(ds.samples), num_workers):
            path, target = ds.samples[i]
            if path.suffix.lower() in (".jpg", ".jpeg"):
                try:
                    yield native.center_crop(path.read_bytes(), input_size), target
                    continue
                except ValueError:
                    pass
            img, _ = ImageFolder.__getitem__(ds, i)
            yield tf(img), target
        return
    ds = ImageFolder(root, transform=center_crop_transform(input_size, pad=32))
    yield from ds.iter_samples(worker_id, num_workers)


def imagefolder_val_loader(root: str, input_size: int, batch_size: int,
                           num_workers: int = 0) -> BatchLoader:
    """The reference val pipeline (train.py:87-89): sequential ImageFolder,
    Resize(+32) / CenterCrop / normalize. ``rebatch`` keeps the dataset's
    tail to one partial batch across any worker count, preserving the
    reference's mean-of-batch-means eval metric (train.py:220)."""
    from tae_tpu_torch.data import native

    make_iter = functools.partial(_imagefolder_val_iter, root, input_size,
                                  native.available())
    return BatchLoader(make_iter, batch_size, num_workers=num_workers,
                       rebatch=num_workers > 0)


def pad_batch(batch: np.ndarray, target: int) -> tuple[np.ndarray, int]:
    """Pad a short final batch up to ``target`` rows by repeating its first
    row, so every request has the run's one batch shape; returns (padded,
    real_count)."""
    n = batch.shape[0]
    if n == target:
        return batch, n
    pad = np.repeat(batch[:1], target - n, axis=0)
    return np.concatenate([batch, pad], axis=0), n


def clamp_eval_batch(requested: int, model, device: torch.device,
                     mesh=None, flag: str = "--batch_size_per_gpu") -> int:
    """Memory guard for the big eval batches the reference defaults to
    (reference evaluate.py:59-61 uses 8192). Estimates the forward pass's
    footprint per sample and clamps ``requested`` (the global batch) down
    to what fits, a multiple of the data × fsdp ranks.

    Budget per rank = 80% of the device's memory (``TAE_TPU_HBM_BYTES``
    overrides; else ``torch.cuda.mem_get_info``'s total on a CUDA device,
    16 GiB elsewhere) minus the rank's parameter bytes (its shards under a
    mesh, on ``tensor`` and on ``fsdp``). The per-sample activation model
    is the JAX package's: the fp32 input image and patchified target, two
    MLP-hidden-sized bf16 buffers in flight, a few residual-stream buffers,
    and the fp32 prediction; each rank holds its share of the batch."""
    from tae_tpu_torch.parallel.sharding import data_rank
    from tae_tpu_torch.parallel.tensor import local_shard

    cfg = model.cfg
    hbm = int(os.environ.get("TAE_TPU_HBM_BYTES", "0"))
    if not hbm:
        hbm = (torch.cuda.mem_get_info(device)[1] if device.type == "cuda"
               else 16 << 30)

    param_bytes = sum(local_shard(p).numel() * p.element_size()
                      for p in model.parameters())

    p = cfg.patch_size
    n_tok = (cfg.img_size // p) ** 2
    dmax = max(cfg.embed_dim, cfg.decoder_embed_dim)
    hidden = int(4 * dmax)
    act_per_sample = (
        2 * 3 * cfg.img_size ** 2 * 4          # image + patchify target, fp32
        + 2 * n_tok * hidden * 2               # MLP hidden buffers, bf16
        + 4 * n_tok * dmax * 4                 # residual-stream buffers
        + 2 * n_tok * p * p * 3 * 4            # pred + squared error, fp32
    )
    budget = int(hbm * 0.8) - param_bytes
    _, ways = data_rank(mesh)
    if budget <= act_per_sample:
        raise SystemExit(
            f"Model params ({param_bytes / 1e9:.2f} GB a rank) leave no "
            f"memory for eval activations on a {hbm / 1e9:.2f} GB device. "
            f"Shard the params over more devices with --mesh_fsdp N.")
    max_batch = max(budget // act_per_sample * ways, ways)
    if requested <= max_batch:
        return requested
    clamped = max(max_batch // ways * ways, ways)
    print(f"Clamping {flag} {requested} -> {clamped}: the forward pass "
          f"needs ~{act_per_sample * requested // ways / 1e9:.2f} GB a rank "
          f"of activations on top of {param_bytes / 1e9:.2f} GB of params, "
          f"but each device has {hbm / 1e9:.2f} GB. Use more devices or "
          f"--mesh_fsdp to raise the fit (or set TAE_TPU_HBM_BYTES to "
          f"override the estimate).")
    return clamped
