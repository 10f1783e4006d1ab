"""AdamW and the learning-rate schedules (counterpart of
``tae_tpu/train/optim.py``).

The update rule is ``torch.optim.AdamW``'s, which the JAX package
reproduces (decoupled decay applied before the moment step, bias-corrected
moments)::

    p <- p · (1 − lr·wd)
    m <- β₁ m + (1−β₁) g;     v <- β₂ v + (1−β₂) g²
    p <- p − lr · (m/(1−β₁ᵗ)) / (sqrt(v/(1−β₂ᵗ)) + eps)

so the port carries it with ``torch.optim.AdamW`` itself: elementwise work
that the JAX package leaves to XLA, in two parameter groups (decayed and
exempt), ``fused=True`` where the parameters lie on a CUDA device. The
learning rate is host data: a schedule is a plain function of the iteration
and its value is written into the groups each step, with no device read.

:func:`adamw` returns an :class:`Optimizer` pair as the JAX package does:
``init(model)`` makes the optimizer state, ``update(opt, lr)`` applies the
gradients found in ``p.grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[nn.Module], torch.optim.Optimizer]
    update: Callable[[torch.optim.Optimizer, float], None]


def no_decay_mask(model: nn.Module) -> dict[str, bool]:
    """name -> True where weight decay applies: every parameter with
    ``ndim <= 1`` (biases, LayerNorm scales and biases) is exempt;
    everything else decays, the 3-D positional embeddings and the 4-D patch
    weight included."""
    return {name: p.ndim > 1 for name, p in model.named_parameters()}


def trainable_parameters(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if not named:
        raise ValueError(
            "the model has no parameter that requires a gradient; build it "
            "with trainable=True (a quantized or serving model is frozen)")
    return named


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype=None) -> Optimizer:
    """``moment_dtype`` (moments stored in a reduced dtype) is part of the
    JAX signature; ``torch.optim.AdamW`` keeps its moments in the
    parameters' dtype, so anything but None raises."""
    if moment_dtype is not None:
        raise NotImplementedError(
            "adamw(moment_dtype=...) is not ported yet (ROADMAP A9: reduced-"
            "precision moments need an update kernel of the port's own; "
            "torch.optim.AdamW stores moments in the parameters' dtype)")

    def init_fn(model: nn.Module) -> torch.optim.Optimizer:
        named, decays = trainable_parameters(model), no_decay_mask(model)
        decay = [p for name, p in named if decays[name]]
        exempt = [p for name, p in named if not decays[name]]
        groups = [dict(params=decay, weight_decay=float(weight_decay)),
                  dict(params=exempt, weight_decay=0.0)]
        fused = all(p.is_cuda for _, p in named)
        return torch.optim.AdamW([g for g in groups if g["params"]], lr=0.0,
                                 betas=(b1, b2), eps=eps, fused=fused)

    def update_fn(opt: torch.optim.Optimizer, lr: float) -> None:
        for group in opt.param_groups:
            group["lr"] = float(lr)
        opt.step()

    return Optimizer(init=init_fn, update=update_fn)


def set_adamw_state(opt: torch.optim.Optimizer, model: nn.Module, step: int,
                    mu: dict[str, torch.Tensor],
                    nu: dict[str, torch.Tensor]) -> None:
    """Fill ``opt``'s state from moments by parameter name (``mu`` and
    ``nu`` shaped like the state_dict entries) and a step count, as if
    ``step`` updates had run."""
    fused = any(g.get("fused") for g in opt.param_groups)
    for name, p in trainable_parameters(model):
        opt.state[p] = {
            # torch keeps the count as a float32 tensor, on the parameter's
            # device for the fused update
            "step": torch.tensor(float(step), dtype=torch.float32,
                                 device=p.device if fused else "cpu"),
            "exp_avg": mu[name].to(p).clone(),
            "exp_avg_sq": nu[name].to(p).clone(),
        }


def step_lr(max_lr: float, min_lr: float, switch_it: int
            ) -> Callable[[int], float]:
    """The reference's 2-level step schedule: ``max_lr`` until
    ``switch_it``, ``min_lr`` after."""
    def schedule(it: int) -> float:
        return float(max_lr if int(it) < switch_it else min_lr)

    return schedule


def epoch_step_lr(base_lr: float, step_size: int = 90, gamma: float = 0.1
                  ) -> Callable[[int], float]:
    """torch StepLR semantics: lr = base · γ^(epoch // step_size)."""
    def schedule(epoch: int) -> float:
        return float(base_lr * gamma ** (int(epoch) // step_size))

    return schedule
