"""Shared driver plumbing: argument groups, model and dataset construction
(counterpart of the host half of ``tae_tpu/cli/_common.py``).

Flag names stay those of the JAX package's drivers (and the reference's),
so a launch script ports with a module-name change. ``--device`` places the
run (``cuda`` by default; ``--device cpu`` runs the plain PyTorch versions,
as the tests do); the mesh flags exist for the same scripts and refuse a
mesh, which the port does not have yet (ROADMAP A13).
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
                   help="fsdp mesh axis size (>1 is not ported: ROADMAP A13)")
    g.add_argument("--mesh_tensor", default=1, type=int,
                   help="tensor-parallel mesh axis size (>1 is not ported: "
                        "ROADMAP A13)")
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
                   help="accepted for compatibility; the port runs one "
                        "process")
    g.add_argument("--model_args", default="", type=str,
                   help="JSON dict of config overrides for the model factory "
                        "(e.g. '{\"embed_dim\": 64}'; used by tests/smoke runs)")


def device_of(args) -> torch.device:
    """The run's device, after refusing a mesh the port cannot build."""
    for flag in ("mesh_fsdp", "mesh_tensor"):
        if getattr(args, flag, 1) > 1:
            raise SystemExit(f"--{flag} {getattr(args, flag)}: parameter and "
                             "tensor sharding are not ported yet (ROADMAP "
                             "A13, multi-GPU); the port runs on one device")
    return torch.device(args.device)


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


def frozen_encoder(args, device: torch.device):
    """The downstream drivers' frozen TAE encoder: ``--encoder`` built on
    ``device``, initialised from seed ``--seed`` + 1, ``--encoder_ckpt``
    loaded, cast once to bf16, pruned to its encoder half (the stage only
    ever runs ``forward_encoder``) and, with ``--encoder_quantization
    int8``, rewritten for int8 serving. Every parameter frozen."""
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
    return encoder.requires_grad_(False)


def fetch_metrics(metrics: dict):
    """Start copying a step's metrics (0-dim tensors) to the host: one
    stacked tensor, copied ``non_blocking`` into pinned memory right behind
    the step, and an event after the copy. :func:`host_metrics` waits on that
    event alone, so reading step k after step k+1 was queued does not wait
    for step k+1."""
    names = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in names])
    if not vals.is_cuda:
        return names, vals, None
    host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return names, host, done


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


def wds_train_loader(args, batch_size: int) -> BatchLoader:
    """The reference train pipeline (train.py:84-85): a resampled infinite
    stream, a 10k shuffle, RandomResizedCrop / flip / normalize. The native
    prebatched decode where the decoder is built, else PIL per sample; says
    which."""
    from tae_tpu_torch.data import native

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
            scale, ratio, args.seed, 0, 1, batch_size, u8)
        return BatchLoader(make_iter, batch_size, num_workers=args.num_workers,
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
        args.seed, 0, 1)
    return BatchLoader(make_iter, batch_size, num_workers=args.num_workers)


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
                     flag: str = "--batch_size_per_gpu") -> int:
    """Memory guard for the big eval batches the reference defaults to
    (reference evaluate.py:59-61 uses 8192). Estimates the forward pass's
    footprint per sample and clamps ``requested`` down to what fits.

    Budget = 80% of the device's memory (``TAE_TPU_HBM_BYTES`` overrides;
    else ``torch.cuda.mem_get_info``'s total on a CUDA device, 16 GiB
    elsewhere) minus the model's parameter bytes. The per-sample
    activation model is the JAX package's: the fp32 input image and
    patchified target, two MLP-hidden-sized bf16 buffers in flight, a few
    residual-stream buffers, and the fp32 prediction."""
    cfg = model.cfg
    hbm = int(os.environ.get("TAE_TPU_HBM_BYTES", "0"))
    if not hbm:
        hbm = (torch.cuda.mem_get_info(device)[1] if device.type == "cuda"
               else 16 << 30)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

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
    if budget <= act_per_sample:
        raise SystemExit(
            f"Model params ({param_bytes / 1e9:.2f} GB) leave no memory for "
            f"eval activations on a {hbm / 1e9:.2f} GB device (parameter "
            f"sharding, --mesh_fsdp, is ROADMAP A13).")
    max_batch = max(budget // act_per_sample, 1)
    if requested <= max_batch:
        return requested
    print(f"Clamping {flag} {requested} -> {max_batch}: the forward pass "
          f"needs ~{act_per_sample * requested / 1e9:.2f} GB of activations "
          f"on top of {param_bytes / 1e9:.2f} GB of params, but the device "
          f"has {hbm / 1e9:.2f} GB (set TAE_TPU_HBM_BYTES to override the "
          f"estimate).")
    return max_batch
