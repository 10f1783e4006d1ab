"""Train and eval step factories (counterpart of ``tae_tpu/train/step.py``).

One step is forward, backward, gradient accumulation, AdamW and the metric
scalars. The JAX package compiles it into one program (``jax.jit``); the
port runs it from a captured CUDA graph on one card
(:mod:`tae_tpu_torch.train.step_graphs`: an eager first step, a capture on
the second, replays after) and eagerly elsewhere (the CPU, a sharded model,
``cuda_graphs=False``). Eval steps are served from
:class:`~tae_tpu_torch.serving_graphs.GraphCache`, as the ``Tokenizer``
serves requests. The JAX package returns a new ``TrainState``; the port
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

from tae_tpu_torch.parallel.tensor import local_shard
from tae_tpu_torch.serving_graphs import (GraphCache, graphs_mode, signature,
                                          tree_map)
from tae_tpu_torch.train.optim import Optimizer, learning_rate

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
    as a 0-dim tensor on their device. Sharded tensors (``DTensor``s, on
    one mesh or several: FSDP2's ``data`` × ``fsdp`` mesh, and that mesh
    with ``tensor`` for the split blocks) count each element once: the norm
    of each mesh's tensors is made whole, then the norms combined."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    by_mesh: dict = {}
    for t in tensors:
        by_mesh.setdefault(getattr(t, "device_mesh", None), []).append(
            t.float())
    norms = []
    for mesh, group in by_mesh.items():
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(group)))
        norms.append(norm if mesh is None else norm.full_tensor())
    return torch.linalg.vector_norm(torch.stack(norms))


def _microbatches(batch: Batch, accum_iter: int) -> list[Batch]:
    """Every tensor leaf (B, ...) cut into ``accum_iter`` consecutive
    microbatches of B // accum_iter."""
    def check(x):
        if x.shape[0] % accum_iter:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"accum_iter {accum_iter}")
        return x

    tree_map(check, batch)
    return [tree_map(lambda x, i=i: x.reshape(accum_iter, -1, *x.shape[1:])[i],
                      batch) for i in range(accum_iter)]


def step_graphs_mode(requested: bool | None, model: nn.Module) -> bool:
    """Whether steps of ``model`` run from CUDA graphs
    (:func:`tae_tpu_torch.serving_graphs.graphs_mode`): ``requested`` as
    given, None meaning on for a model on a CUDA device that is not sharded
    (by ``fully_shard`` or the tensor split, whose collectives a graph does
    not hold); True on another device or a sharded model raises."""
    from tae_tpu_torch.parallel.sharding import is_sharded

    return graphs_mode(requested, next(model.parameters()).device,
                       is_sharded(model))


def make_train_step(loss_fn: LossFn, optimizer: Optimizer,
                    schedule: Callable[[int], float], accum_iter: int = 1,
                    clip_grad: float | None = None,
                    cuda_graphs: bool | None = None, pool=None):
    """Build ``step(state, batch, it) -> (state, metrics)``.

    ``accum_iter > 1`` runs the microbatches in turn; their gradients sum
    in the fp32 ``.grad`` buffers and are divided by ``accum_iter`` before
    the single optimizer update, and the loss is the mean of the microbatch
    losses. ``clip_grad`` scales the gradients by
    ``min(1, clip / (norm + 1e-6))``. ``metrics``: ``loss``, ``lr``,
    ``grad_norm`` (before clipping) and the loss function's aux values, all
    0-dim device tensors. On a model placed by ``parallel.shard_model``
    the loss (and the aux values) are this rank's, over its rows; the
    gradient norm is the global one.

    ``cuda_graphs``: run the steps from captured CUDA graphs
    (:mod:`tae_tpu_torch.train.step_graphs`; :func:`step_graphs_mode`
    says when: None on for a model on one CUDA device that is not sharded,
    True raises elsewhere, False eager). ``pool``: the
    :class:`~tae_tpu_torch.serving_graphs.GraphPool` the step's graphs
    share with others (a driver's eval pass; None: their own). ``step.graphs``
    is the :class:`StepGraphs` (None when the mode is off for every
    model)."""

    def device_step(state: TrainState, batch: Batch, plan=None, host=None):
        """The step's device part and the optimizer's plan; ``host(plan)``
        runs the optimizer's host part before its update (the eager step)."""
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
        # in place on each rank's shards: sharded gradients may lie on
        # several meshes, which one DTensor operation cannot mix
        shards = [local_shard(g) for g in grads]
        if accum_iter > 1:
            torch._foreach_div_(shards, float(accum_iter))
        gnorm = global_norm(grads)
        if clip_grad is not None:
            scale = torch.clamp(clip_grad / (gnorm + 1e-6), max=1.0)
            torch._foreach_mul_(shards, scale)
        plan = optimizer.bind(opt, plan)
        if host is not None:
            host(plan)
        optimizer.apply(opt, plan)
        metrics = {"loss": loss, "lr": learning_rate(opt).clone(),
                   "grad_norm": gnorm,
                   **{k: torch.as_tensor(v).detach() for k, v in aux.items()}}
        return metrics, plan

    def eager(state: TrainState, batch: Batch, it: int
              ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        lr = schedule(it)
        metrics, _ = device_step(
            state, batch, host=lambda plan: optimizer.host(state.opt, lr, plan))
        return state, metrics

    if cuda_graphs is False:
        eager.graphs = None
        return eager
    from tae_tpu_torch.train.step_graphs import StepGraphs

    graphs = StepGraphs(device_step, optimizer, schedule, pool=pool)

    def step(state: TrainState, batch: Batch, it: int
             ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        if step_graphs_mode(cuda_graphs, state.model):
            return graphs(state, batch, it)
        return eager(state, batch, it)

    step.graphs = graphs
    return step


def make_eval_fn(fn: Callable, model: nn.Module,
                 cuda_graphs: bool | None = None, pool=None):
    """``fn(*args)``, a forward of ``model`` without gradients on tensors
    already on its device, served from CUDA graphs of ``model``
    (:class:`~tae_tpu_torch.serving_graphs.GraphCache`: eager on a shape's
    first call, captured on the second, replayed after; fresh outputs)
    where :func:`step_graphs_mode` says so, else run as it is. The port's
    counterpart of the JAX drivers' jitted eval functions. ``pool``: the
    :class:`~tae_tpu_torch.serving_graphs.GraphPool` its graphs share (a
    driver's train step's; None: their own). ``eval_fn.cuda_graphs`` says
    which mode runs; ``eval_fn.graphs`` is the cache (None when off)."""
    on = step_graphs_mode(cuda_graphs, model)
    cache = GraphCache(pool=pool) if on else None

    @torch.no_grad()
    def eval_fn(*args):
        if cache is None:
            return fn(*args)
        return cache(model, signature(args), lambda a: fn(*a), args)

    eval_fn.cuda_graphs, eval_fn.graphs = on, cache
    return eval_fn


def make_eval_step(loss_fn: LossFn):
    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Batch) -> dict[str, torch.Tensor]:
        loss, aux = loss_fn(model, batch)
        return {"loss": loss, **aux}

    return eval_step
