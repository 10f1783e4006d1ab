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
exempt), ``fused=True`` where the parameters lie on a CUDA device. With
``moment_dtype`` (moments stored in a reduced type, computed in fp32, as
``tae_tpu.train.adamw(moment_dtype=)`` keeps them) it is
:class:`AdamWMoments`, whose step is one launch of the port's K18
(:mod:`tae_tpu_torch.ops.cuda.adamw`). The learning rate is host data: a
schedule is a plain function of the iteration and its value is written into
the groups each step, with no device read.

:func:`adamw` returns an :class:`Optimizer` pair as the JAX package does:
``init(model)`` makes the optimizer state, ``update(opt, lr)`` applies the
gradients found in ``p.grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from tae_tpu_torch.parallel.tensor import local_shard


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


class AdamWMoments(torch.optim.Optimizer):
    """AdamW with both moments stored in ``moment_dtype`` (bf16, fp16 or
    fp32) and the update in fp32, in the JAX package's order: one K18
    launch a step on CUDA tensors (per dtype pair), its plain version on the
    CPU. The state is ``torch.optim.AdamW``'s (``step`` a float32 CPU
    tensor, ``exp_avg``, ``exp_avg_sq``) with the moments in their own
    type, so ``state_dict`` / ``load_state_dict`` and
    :func:`set_adamw_state` carry it; under FSDP2 each moment is a DTensor
    placed as its parameter and K18 runs on the local shards."""

    def __init__(self, groups, *, betas: tuple[float, float], eps: float,
                 moment_dtype: torch.dtype):
        super().__init__(groups, dict(lr=0.0, betas=betas, eps=eps,
                                      weight_decay=0.0))
        self.moment_dtype = moment_dtype

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.tensor(0.0, dtype=torch.float32)
            for key in ("exp_avg", "exp_avg_sq"):
                state[key] = torch.zeros_like(
                    p, dtype=self.moment_dtype,
                    memory_format=torch.preserve_format)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        from tae_tpu_torch.ops.cuda.adamw import (adamw_update,
                                                  bias_corrections,
                                                  decay_factor)

        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        by_hyper: dict[tuple, list] = {}
        corrections: dict[tuple, tuple[float, float]] = {}
        for group in self.param_groups:
            (b1, b2), eps = group["betas"], group["eps"]
            lr = float(group["lr"])
            decay = decay_factor(lr, group["weight_decay"])
            rows = by_hyper.setdefault((b1, b2, eps), [])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._state(p)
                state["step"] += 1
                key = (b1, b2, int(state["step"]))
                if key not in corrections:
                    corrections[key] = bias_corrections(*key)
                rows.append((local_shard(p), local_shard(p.grad),
                             local_shard(state["exp_avg"]),
                             local_shard(state["exp_avg_sq"]), decay, lr,
                             *corrections[key]))
        for (b1, b2, eps), rows in by_hyper.items():
            if rows:
                adamw_update(*map(list, zip(*rows)), b1=b1, b2=b2, eps=eps)
        return loss

    def load_state_dict(self, state_dict: dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, with the moments kept
        in ``moment_dtype`` (the base class casts every floating state to
        its parameter's dtype)."""
        saved = state_dict["state"]
        super().load_state_dict({**state_dict, "state": {}})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            if i not in saved:
                continue
            self.state[p] = {
                k: v if k == "step" else v.to(device=p.device,
                                              dtype=self.moment_dtype)
                for k, v in saved[i].items()}


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype=None) -> Optimizer:
    """``moment_dtype`` (for example ``torch.bfloat16``) stores both moments
    in that type, halving the optimizer state of the large configs (the
    update still computes in fp32): :class:`AdamWMoments`, one K18 launch a
    step. ``None`` keeps them in the parameters' dtype:
    ``torch.optim.AdamW``, fused on CUDA parameters."""
    from tae_tpu_torch.ops.cuda.adamw import MOMENT_DTYPES

    if moment_dtype is not None and moment_dtype not in MOMENT_DTYPES:
        raise TypeError(f"moment_dtype must be one of {MOMENT_DTYPES} or "
                        f"None, not {moment_dtype}")

    def init_fn(model: nn.Module) -> torch.optim.Optimizer:
        named, decays = trainable_parameters(model), no_decay_mask(model)
        decay = [p for name, p in named if decays[name]]
        exempt = [p for name, p in named if not decays[name]]
        groups = [g for g in (dict(params=decay,
                                   weight_decay=float(weight_decay)),
                              dict(params=exempt, weight_decay=0.0))
                  if g["params"]]
        if moment_dtype is not None:
            return AdamWMoments(groups, betas=(b1, b2), eps=eps,
                                moment_dtype=moment_dtype)
        fused = all(p.is_cuda for _, p in named)
        return torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps,
                                 fused=fused)

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
    ``step`` updates had run. The moments take the optimizer's moment type
    (:class:`AdamWMoments`) or the parameters' dtype; under FSDP2 and the
    tensor split they are placed as their parameters (a split qkv's rows
    grouped by rank first)."""
    from tae_tpu_torch.parallel.tensor import to_ranks

    mu, nu = to_ranks(mu, model), to_ranks(nu, model)
    fused = any(g.get("fused") for g in opt.param_groups)
    moment_dtype = getattr(opt, "moment_dtype", None)

    def placed(full: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        full = full.to(device=p.device, dtype=moment_dtype or p.dtype)
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(p, DTensor):
            return distribute_tensor(full, p.device_mesh, p.placements)
        return full.clone()

    for name, p in trainable_parameters(model):
        opt.state[p] = {
            # torch keeps the count as a float32 tensor, on the parameter's
            # device for the fused update
            "step": torch.tensor(float(step), dtype=torch.float32,
                                 device=p.device if fused else "cpu"),
            "exp_avg": placed(mu[name], p),
            "exp_avg_sq": placed(nu[name], p),
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
