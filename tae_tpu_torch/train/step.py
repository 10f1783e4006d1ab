"""Train and eval step factories (counterpart of ``tae_tpu/train/step.py``).

One step is forward, backward, gradient accumulation, AdamW and the metric
scalars, run eagerly. The JAX package returns a new ``TrainState``; the port
updates the model and the optimizer **in place** (PyTorch's own way, and it
saves a second copy of 380 M parameters and moments) and returns the same
state object.

As in the JAX package, no ``loss.item()`` and no synchronize happens inside a
step: the metrics come back as 0-dim device tensors and the caller fetches
them when it logs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from tae_tpu_torch.train.optim import Optimizer

Batch = Any
# loss_fn(model, batch) -> (loss, aux metrics dict)
LossFn = Callable[[nn.Module, Batch], tuple[torch.Tensor, dict]]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt: torch.optim.Optimizer

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer) -> "TrainState":
        return cls(model=model, opt=optimizer.init(model))


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all tensors (an iterable, or a dict's values), in fp32,
    as a 0-dim tensor on their device."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    tensors = [t.float() for t in tensors]
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))


def _tree_map(fn, batch: Batch) -> Batch:
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return batch


def _microbatches(batch: Batch, accum_iter: int) -> list[Batch]:
    """Every tensor leaf (B, ...) cut into ``accum_iter`` consecutive
    microbatches of B // accum_iter."""
    def check(x):
        if x.shape[0] % accum_iter:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"accum_iter {accum_iter}")
        return x

    _tree_map(check, batch)
    return [_tree_map(lambda x, i=i: x.reshape(accum_iter, -1, *x.shape[1:])[i],
                      batch) for i in range(accum_iter)]


def make_train_step(loss_fn: LossFn, optimizer: Optimizer,
                    schedule: Callable[[int], float], accum_iter: int = 1,
                    clip_grad: float | None = None):
    """Build ``step(state, batch, it) -> (state, metrics)``.

    ``accum_iter > 1`` runs the microbatches in turn; their gradients sum
    in the fp32 ``.grad`` buffers and are divided by ``accum_iter`` before
    the single optimizer update, and the loss is the mean of the microbatch
    losses. ``clip_grad`` scales the gradients by
    ``min(1, clip / (norm + 1e-6))``. ``metrics``: ``loss``, ``lr``,
    ``grad_norm`` (before clipping) and the loss function's aux values, all
    0-dim device tensors."""

    def step(state: TrainState, batch: Batch, it: int
             ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        lr = schedule(it)
        model, opt = state.model, state.opt
        opt.zero_grad(set_to_none=True)
        if accum_iter == 1:
            loss, aux = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            losses, auxes = [], []
            for micro in _microbatches(batch, accum_iter):
                micro_loss, micro_aux = loss_fn(model, micro)
                micro_loss.backward()
                losses.append(micro_loss.detach())
                auxes.append(micro_aux)
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([torch.as_tensor(a[k]).detach()
                                   for a in auxes]).mean() for k in auxes[0]}
        grads = [p.grad for group in opt.param_groups for p in group["params"]
                 if p.grad is not None]
        if accum_iter > 1:
            torch._foreach_div_(grads, float(accum_iter))
        gnorm = global_norm(grads)
        if clip_grad is not None:
            scale = torch.clamp(clip_grad / (gnorm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, scale)
        optimizer.update(opt, lr)
        metrics = {"loss": loss,
                   "lr": torch.full((), lr, dtype=torch.float32,
                                    device=loss.device),
                   "grad_norm": gnorm,
                   **{k: torch.as_tensor(v).detach() for k, v in aux.items()}}
        return state, metrics

    return step


def make_eval_step(loss_fn: LossFn):
    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Batch) -> dict[str, torch.Tensor]:
        loss, aux = loss_fn(model, batch)
        return {"loss": loss, **aux}

    return eval_step
