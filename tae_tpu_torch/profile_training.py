"""Where the time of a train step goes, by CUDA kernel.

Run on a machine with a CUDA card, from the repository root::

    python -m tae_tpu_torch.profile_training --batch 64
    python -m tae_tpu_torch.profile_training --batch 64 --remat

Builds the named model (``--model``, any registered TAE config) at full size
for training (fp32 parameters from a seeded generator, bf16 compute), takes
``--steps`` train steps (``make_train_step``: forward, backward, AdamW) on
one seeded batch under ``torch.profiler`` after ``--warmup`` unprofiled
ones, and prints: the device time of each kernel name per step with its
launches per step, the sum over all kernels, the wall time per step (host
clock to a synchronize), the busy share (kernel time / wall time), images
per second and the peak device memory. The card's name and power limit head
the output.

``--recipe rec19k`` profiles the downstream recognition step instead (the
JAX bench's ``train_rec19k_int8enc_mb64`` recipe, ``chip_smoke.py``'s
``rec19k`` path): the frozen p16 encoder in its int8 serving layout under
``no_grad`` feeding ``vit_recognition_numpatches256_vocab256_base`` with the
19167-class head, AdamW without weight decay::

    python -m tae_tpu_torch.profile_training --recipe rec19k --batch 64 [--remat]
"""

from __future__ import annotations

import argparse
import sys

import torch

from tae_tpu_torch.profile_serving import card_line, profile, short


#: the recipe of the train path: AdamW with this decay, bf16 compute
WEIGHT_DECAY = 0.05


def build_state(model_name: str, seed: int = 0, device="cuda", **overrides):
    """The model built for training on ``device`` (fp32 parameters from a
    seeded generator, every one requiring a gradient) with a fresh AdamW
    state."""
    from tae_tpu_torch import models
    from tae_tpu_torch.train import TrainState, adamw

    model = models.create(model_name, device=device, trainable=True,
                          **overrides)
    model.init_weights_(torch.Generator(device=device).manual_seed(seed))
    return TrainState.create(model, adamw(weight_decay=WEIGHT_DECAY))


def make_step(remat: bool = False, backend: str | None = None,
              accum_iter: int = 1, policy=None):
    """The step function of the bench recipe: bf16 compute (or ``policy``,
    for example ``utils.dtypes.FP32``), AdamW, ``step_lr(1e-4, 1e-5,
    450_000)``. It works on any state of :func:`build_state`."""
    from tae_tpu_torch.train import adamw, make_train_step, step_lr
    from tae_tpu_torch.utils.dtypes import Policy

    policy = Policy() if policy is None else policy

    def loss_fn(m, batch):
        return m(batch, policy=policy, backend=backend, remat=remat)[0], {}

    return make_train_step(loss_fn, adamw(weight_decay=WEIGHT_DECAY),
                           step_lr(1e-4, 1e-5, 450_000), accum_iter=accum_iter)


REC19K_ENCODER = "tae_patch16_vocab256_px256"
REC19K_MODEL = "vit_recognition_numpatches256_vocab256_base"
REC19K_CLASSES = 19167


def build_rec19k(batch: int, remat: bool, backend: str | None, seed: int = 0):
    """The rec19k recipe: ``(state, step, (images, labels))``, the frozen
    encoder built as the downstream drivers build it
    (``cli._common.frozen_encoder``)."""
    import types

    from tae_tpu_torch import models
    from tae_tpu_torch.cli._common import frozen_encoder
    from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
    from tae_tpu_torch.train.losses import cross_entropy
    from tae_tpu_torch.utils.dtypes import Policy

    encoder = frozen_encoder(types.SimpleNamespace(
        encoder=REC19K_ENCODER, encoder_args="", encoder_ckpt="", seed=seed,
        encoder_quantization="int8", encoder_equalize=0.0),
        torch.device("cuda"))
    model = models.create(REC19K_MODEL, num_classes=REC19K_CLASSES,
                          device="cuda", trainable=True)
    model.init_weights_(torch.Generator(device="cuda").manual_seed(seed))
    enc_policy = Policy(param_dtype=torch.bfloat16)

    def loss_fn(m, b):
        x, y = b
        with torch.no_grad():
            z = encoder.forward_encoder(x, policy=enc_policy, backend=backend)
        return cross_entropy(m(z, backend=backend, remat=remat), y), {}

    opt = adamw(weight_decay=0.0)
    step = make_train_step(loss_fn, opt, step_lr(1e-4, 1e-5, 500_000))
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((batch, 3, 256, 256), generator=gen, device="cuda")
    labels = torch.arange(batch, device="cuda") % REC19K_CLASSES
    return TrainState.create(model, opt), step, (images, labels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tae_patch16_vocab256_px256")
    ap.add_argument("--recipe", default="tae", choices=["tae", "rec19k"],
                    help="rec19k: the downstream recognition step (see the "
                         "module docstring; --model is ignored)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--backend", default=None, choices=[None, "reference"],
                    help="reference: the plain PyTorch versions, to compare")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    print(card_line())
    if args.recipe == "rec19k":
        state, step, batch = build_rec19k(args.batch, args.remat, args.backend,
                                          args.seed)
        title = f"rec19k ({REC19K_MODEL}, int8 {REC19K_ENCODER} encoder)"
    else:
        state = build_state(args.model, args.seed)
        step = make_step(args.remat, args.backend)
        cfg = state.model.cfg
        gen = torch.Generator(device="cuda").manual_seed(1)
        batch = torch.randn((args.batch, cfg.in_chans, cfg.img_size,
                             cfg.img_size), generator=gen, device="cuda")
        title = args.model
    it = 0

    def one_step(x):
        nonlocal it
        step(state, x, it)
        it += 1

    for _ in range(args.warmup):
        one_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, wall = profile(one_step, batch, args.steps)
    # the optimizer's profiler range spans its own kernels on the device
    # timeline; counting it would count them twice
    rows = {k: v for k, v in rows.items() if not k.startswith("Optimizer.")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = sum(ms for ms, _ in rows.values())
    mode = ("remat" if args.remat else "no remat") + (
        f" backend={args.backend}" if args.backend else "")
    print(f"== {title} train step B={args.batch} {mode}: kernels "
          f"{total:.3f} ms, wall {wall:.3f} ms per step, busy share "
          f"{total / wall:.3f}, {args.batch / wall * 1e3:.1f} img/s, peak "
          f"memory {peak:.2f} GiB")
    for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f} ms  {100 * ms / total:5.1f}%  x{n:<6g} "
              f"{short(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
