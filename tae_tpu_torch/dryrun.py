"""Entry points: the flagship forward, and a dry run of every training
topology over a multi-process mesh (counterpart of ``__graft_entry__.py``).

``python -m tae_tpu_torch.dryrun [N]`` runs :func:`dryrun_multichip` with N
(default 4) gloo processes on the CPU and prints one ``ok`` line a
topology.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

#: the dry run's tiny TAE (the JAX dry run's config)
TINY = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
            vocab_size=16)
#: one process against N: float32 sums in another order
LOSS_RTOL = 1e-5
LATENT_ATOL = 1e-5


def entry(device: str = "cuda"):
    """``(fn, example_args)``: the forward of the flagship model
    (``tae_patch16_vocab256_px256``, the reference's best-MSE config) at
    B = 8, weights from seed 0."""
    from tae_tpu_torch import models

    model = models.create("tae_patch16_vocab256_px256", device=device)
    model.init_weights_(torch.Generator(device=device).manual_seed(0))
    imgs = torch.zeros((8, 3, 256, 256), device=device)

    def fn(model, imgs):
        with torch.no_grad():
            return model(imgs)

    return fn, (model, imgs)


def factor_mesh(n: int) -> tuple[int, int, int]:
    """The JAX dry run's ``_factor_mesh`` (data, fsdp, tensor), every axis
    active where ``n`` allows: 4 -> (1, 2, 2), 8 -> (2, 2, 2)."""
    tensor = 2 if n % 2 == 0 else 1
    rem = n // tensor
    fsdp = 2 if rem % 2 == 0 else 1
    return rem // fsdp, fsdp, tensor


def global_mean(value: torch.Tensor, mesh) -> float:
    """A rank's mean over its rows -> the mean over the global batch."""
    from tae_tpu_torch.parallel.mesh import all_reduce_sum
    from tae_tpu_torch.parallel.sharding import data_rank

    _, count = data_rank(mesh)
    return float(all_reduce_sum([float(value)], mesh)[0]) / count


def topologies(mesh, n_devices: int) -> dict:
    """One step of each topology on ``mesh`` (None: one process, the whole
    batch): the TAE train step with ``accum_iter=2``, recognition and
    segmentation on the frozen bf16 encoder, and the int8 serving encode.
    Returns the global-batch losses and this rank's latents (None on a
    tensor rank above 0, whose rows its tensor peer 0 holds)."""
    from tae_tpu_torch.cli.train_segmentation import criterion
    from tae_tpu_torch.models.recognition import (RecognitionConfig,
                                                  RecognitionViT)
    from tae_tpu_torch.models.segmentation import (SegmentationConfig,
                                                   SegmentationViT)
    from tae_tpu_torch.models.tae import TAE, TAEConfig
    from tae_tpu_torch.ops.int8 import prepare_serving_
    from tae_tpu_torch.parallel import batch_slice, shard_model
    from tae_tpu_torch.tokenizer import prune_component
    from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
    from tae_tpu_torch.train.losses import cross_entropy
    from tae_tpu_torch.utils.dtypes import FP32, Policy

    cfg = TAEConfig(**TINY)
    rng = np.random.default_rng(1)
    n = 2 * n_devices
    images = torch.from_numpy(
        rng.standard_normal((n, 3, cfg.img_size, cfg.img_size), np.float32))
    batch = batch_slice(images, mesh)
    out = {}

    def seeded(model, seed):
        model.init_weights_(torch.Generator().manual_seed(seed))
        return model

    opt = adamw(weight_decay=0.05)
    model = shard_model(seeded(TAE(cfg, trainable=True), 0), mesh)
    step = make_train_step(lambda m, b: (m(b, policy=FP32)[0], {}), opt,
                           step_lr(1e-3, 1e-4, 100), accum_iter=2)
    _, metrics = step(TrainState.create(model, opt), batch, 0)
    out["tae"] = global_mean(metrics["loss"], mesh)

    # the frozen bf16 encoder the downstream topologies share, whole on
    # every rank
    encoder = prune_component(seeded(TAE(cfg), 0).to(torch.bfloat16),
                              "encoder")
    enc_policy = Policy(param_dtype=torch.bfloat16)

    def encode(imgs):
        with torch.no_grad():
            return encoder.forward_encoder(imgs, policy=enc_policy)

    rec = shard_model(seeded(RecognitionViT(RecognitionConfig(
        num_patches=cfg.num_patches, vocab_size=cfg.vocab_size,
        decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
        num_classes=10), trainable=True), 2), mesh)
    targets = batch_slice(torch.arange(n) % 10, mesh)

    def rec_loss(m, b):
        imgs, t = b
        return cross_entropy(m(encode(imgs), policy=FP32), t), {}

    rec_step = make_train_step(rec_loss, opt, step_lr(1e-3, 1e-4, 100))
    _, metrics = rec_step(TrainState.create(rec, opt), (batch, targets), 0)
    out["recognition"] = global_mean(metrics["loss"], mesh)

    seg = shard_model(seeded(SegmentationViT(SegmentationConfig(
        num_patches=cfg.num_patches, patch_size=cfg.patch_size,
        vocab_size=cfg.vocab_size, decoder_embed_dim=64, decoder_depth=2,
        decoder_num_heads=4, num_classes=5), trainable=True), 3), mesh)
    masks = (torch.arange(cfg.img_size) % 5).repeat(n, cfg.img_size, 1)
    masks[:, 0] = 255   # ignore_index
    masks = batch_slice(masks, mesh)

    def seg_loss(m, b):
        imgs, t = b
        return criterion(m(encode(imgs), policy=FP32, mesh=mesh), t), {}

    seg_step = make_train_step(seg_loss, opt, step_lr(1e-3, 1e-4, 100))
    _, metrics = seg_step(TrainState.create(seg, opt), (batch, masks), 0)
    out["segmentation"] = global_mean(metrics["loss"], mesh)

    # the int8 serving artifacts are buffers: whole on every rank
    served = prepare_serving_(
        prune_component(seeded(TAE(cfg), 0).to(torch.bfloat16), "encoder"),
        "int8")
    with torch.no_grad():
        z = served.forward_encoder(batch, policy=enc_policy)
    from tae_tpu_torch.parallel.mesh import tensor_rank

    out["int8"] = None if tensor_rank(mesh) else z.float().numpy()
    return out


def _rank_body(rank: int, world: int, sizes: tuple[int, int, int]) -> dict:
    from tae_tpu_torch.parallel import make_mesh

    return topologies(make_mesh(*sizes, device_type="cpu"), world)


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """Run :func:`topologies` in ``n_devices`` gloo CPU processes on
    :func:`factor_mesh`'s (data, fsdp, tensor) mesh and in this process on
    the whole batch; every loss must be finite and equal the one-process
    loss, the int8 latents (of the tensor-rank-0 ranks) the one-process
    latents. Prints an ``ok`` line a topology."""
    from tae_tpu_torch.parallel import spawn

    sizes = factor_mesh(n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn.run(_rank_body, n_devices, sizes,
                          store=str(Path(tmp) / "store"), timeout=timeout)
    one = topologies(None, n_devices)
    for name in ("tae", "recognition", "segmentation"):
        got, want = ranks[0][name], one[name]
        if not (np.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want)):
            raise AssertionError(f"dryrun_multichip {name}: loss {got} on "
                                 f"mesh {sizes}, {want} in one process")
        label = f"tae train mesh={sizes}" if name == "tae" else f"{name} train"
        print(f"dryrun_multichip ok: {label} loss={got:.4f} (one process "
              f"{want:.4f})")
    z = np.concatenate([r["int8"] for r in ranks if r["int8"] is not None])
    if z.shape != one["int8"].shape or not np.isfinite(z).all():
        raise AssertionError(f"dryrun_multichip int8: latents {z.shape}")
    err = float(np.abs(z - one["int8"]).max())
    if err > LATENT_ATOL:
        raise AssertionError(f"dryrun_multichip int8: latents {err} from "
                             "one process")
    print(f"dryrun_multichip ok: int8 serving encode |z|={np.abs(z).mean():.4f}"
          f" (max difference from one process {err:.2e})")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
