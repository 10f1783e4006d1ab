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
schedule is a plain function of the iteration, and its value is written
where the update reads it before each step: into the groups, and into a
0-dim fp32 tensor on the parameters' device (:func:`learning_rate`), which
the fused update on CUDA reads in eager steps and graph replays alike.

:func:`adamw` returns an :class:`Optimizer` pair as the JAX package does:
``init(model)`` makes the optimizer state, ``update(opt, lr)`` applies the
gradients found in ``p.grad``. The update also comes in its host and device
parts, so that a CUDA graph of the train step can hold the device part while
the host part runs before each replay (:mod:`tae_tpu_torch.train.step_graphs`):

- ``bind(opt, plan=None) -> plan``: what the update touches, the gradients
  present now; no device work. Given the plan of an earlier bind, the same
  plan takes the gradients present now.
- ``host(opt, lr, plan)``: ``lr`` and every scalar the update derives from
  it and from the step count (``AdamWMoments``: the decay and the bias
  corrections of each tensor, K18's table) written where the device part
  reads them, by copies on the current stream, outside any graph.
- ``apply(opt, plan)``: the device part, which a graph can hold.

``update`` is the three in turn. Eager and replayed steps run the same
device code on the same values, so they agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from tae_tpu_torch.parallel.tensor import local_shard


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init`` and the update's three parts (the module's docstring);
    :meth:`update` runs them in turn."""
    init: Callable[[nn.Module], torch.optim.Optimizer]
    bind: Callable
    host: Callable
    apply: Callable

    def update(self, opt: torch.optim.Optimizer, lr: float) -> None:
        plan = self.bind(opt)
        self.host(opt, lr, plan)
        self.apply(opt, plan)


def _sharded(opt: torch.optim.Optimizer) -> bool:
    """Whether ``opt``'s parameters are DTensors (FSDP2, the tensor split)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(opt.param_groups[0]["params"][0], DTensor)


def learning_rate(opt: torch.optim.Optimizer) -> torch.Tensor:
    """The 0-dim fp32 tensor that holds ``opt``'s learning rate on its
    parameters' device, made at the first call (outside any graph: an
    eager step comes first) and written by the update's host part."""
    lr = getattr(opt, "_lr_tensor", None)
    if lr is None:
        device = opt.param_groups[0]["params"][0].device
        lr = opt._lr_tensor = torch.zeros((), dtype=torch.float32,
                                          device=device)
    return lr


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
        # K18's device tables, made by the first (eager) update and kept:
        # a graph's update reads them, and they must lie outside its pool
        self._tables: dict = {}

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.tensor(0.0, dtype=torch.float32)
            for key in ("exp_avg", "exp_avg_sq"):
                state[key] = torch.zeros_like(
                    p, dtype=self.moment_dtype,
                    memory_format=torch.preserve_format)
        return state

    def bind(self, plan: list | None = None) -> list:
        """The update's plan: K18's tables of the parameters that have a
        gradient now, grouped by hyperparameters (and by device and dtypes
        within), each row with its group and state. Given an earlier plan,
        its tables take the gradients present now (the same parameters)."""
        from tae_tpu_torch.ops.cuda.adamw import update_tables

        if plan is not None:
            for entries, tab in plan:
                tab.rebind([local_shard(p.grad) for _, p, _ in entries])
            return plan
        by_hyper: dict[tuple, list] = {}
        for group in self.param_groups:
            (b1, b2), eps = group["betas"], group["eps"]
            entries = by_hyper.setdefault((b1, b2, eps), [])
            for p in group["params"]:
                if p.grad is not None:
                    entries.append((group, p, self._state(p)))
        plan = []
        for (b1, b2, eps), entries in by_hyper.items():
            rows = [(local_shard(p), local_shard(p.grad),
                     local_shard(st["exp_avg"]), local_shard(st["exp_avg_sq"]))
                    for _, p, st in entries]
            for idx, tab in update_tables(rows, b1=b1, b2=b2, eps=eps,
                                          tables=self._tables):
                plan.append(([entries[i] for i in idx], tab))
        return plan

    @torch.no_grad()
    def count(self, plan: list) -> None:
        """The host part: each planned tensor's step counted, and its
        scalars (decay, lr, bias corrections: fp32 values from the step
        count, as the JAX package forms them) written into its table on
        the device."""
        from tae_tpu_torch.ops.cuda.adamw import bias_corrections, decay_factor

        corrections: dict[tuple, tuple[float, float]] = {}
        by_group: dict[int, tuple[float, float]] = {}
        for entries, tab in plan:
            steps = [st["step"] for _, _, st in entries]
            torch._foreach_add_(steps, 1.0)
            counts = torch.stack(steps).tolist() if steps else []
            scalars = []
            for (group, _, _), n in zip(entries, counts):
                key = (tab.b1, tab.b2, int(n))
                if key not in corrections:
                    corrections[key] = bias_corrections(*key)
                hyper = by_group.get(id(group))
                if hyper is None:
                    lr = float(group["lr"])
                    hyper = by_group[id(group)] = (
                        decay_factor(lr, group["weight_decay"]), lr)
                scalars.append((*hyper, *corrections[key]))
            tab.write(scalars)

    @staticmethod
    def launch(plan: list) -> None:
        """The device part: one K18 launch a table (its plain version on
        the CPU)."""
        for _, tab in plan:
            tab.launch()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        plan = self.bind()
        self.count(plan)
        self.launch(plan)
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

    def bind_fn(opt: torch.optim.Optimizer, plan=None):
        return opt.bind(plan) if moment_dtype is not None else None

    def host_fn(opt: torch.optim.Optimizer, lr: float, plan) -> None:
        for group in opt.param_groups:
            group["lr"] = float(lr)
        learning_rate(opt).fill_(float(lr))
        if moment_dtype is not None:
            opt.count(plan)

    def apply_fn(opt: torch.optim.Optimizer, plan) -> None:
        if moment_dtype is not None:
            opt.launch(plan)
            return
        lr = learning_rate(opt)
        if not lr.is_cuda or _sharded(opt):
            # the CPU, and FSDP2's DTensors (which run eagerly): the float
            opt.step()
            return
        # on the card the update reads the learning rate from the device,
        # so that a graph replays the value the host wrote before it; the
        # groups keep the float (state_dict, checkpoints) outside the step
        capturing = torch.cuda.is_current_stream_capturing()
        saved = [(g["lr"], g["capturable"]) for g in opt.param_groups]
        for g in opt.param_groups:
            g["lr"] = lr
            g["capturable"] = capturing or not g.get("fused")
        try:
            opt.step()
        finally:
            for g, (value, capturable) in zip(opt.param_groups, saved):
                g["lr"], g["capturable"] = value, capturable

    return Optimizer(init=init_fn, bind=bind_fn, host=host_fn,
                     apply=apply_fn)


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
