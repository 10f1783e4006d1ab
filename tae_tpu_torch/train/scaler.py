"""Dynamic loss scaling (counterpart of ``tae_tpu/train/scaler.py``).

torch ``GradScaler``'s rules (scale the loss; on non-finite gradients skip
the step and halve the scale; after ``growth_interval`` clean steps double
it) on state held in device tensors. ``GradScaler.step`` reads its
``found_inf`` on the host, so a step that uses it cannot be replayed from a
captured CUDA graph (:mod:`tae_tpu_torch.train.step_graphs`); here nothing
is read on the host, and the update writes the state's own tensors in
place, so a graph replays it on the same storage, as the JAX version
composes with ``jit``. bf16 has fp32's exponent range and needs no scale:
the train step takes none, as the JAX package's does not.

Gradients are given as a tree of tensors (a tensor, or lists, tuples and
dicts of them) and come back unscaled in fp32, zeroed where any is not
finite, so that a step masked by ``finite`` is a clean no-op.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from tae_tpu_torch.serving_graphs import tensors, tree_map


class ScalerState(NamedTuple):
    scale: torch.Tensor           # () fp32
    growth_tracker: torch.Tensor  # () int32, consecutive finite steps

    @classmethod
    def create(cls, init_scale: float = 2.0 ** 16,
               device=None) -> "ScalerState":
        return cls(torch.full((), init_scale, dtype=torch.float32,
                              device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


class DynamicLossScale:
    """Functional GradScaler. Inside a train step::

        loss_scaled = scaler.scale(state, loss)
        grads = ... d loss_scaled ...
        grads, state, finite = scaler.unscale_and_update(state, grads)
        # apply the optimizer update only where ``finite``
    """

    def __init__(self, growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000):
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval

    def scale(self, state: ScalerState, loss: torch.Tensor) -> torch.Tensor:
        return loss * state.scale.to(loss.dtype)

    def unscale_and_update(self, state: ScalerState, grads: Any
                           ) -> tuple[Any, ScalerState, torch.Tensor]:
        """``(grads unscaled in fp32, state, finite)``; ``state`` is the
        one given, its tensors updated in place."""
        inv = 1.0 / state.scale
        grads = tree_map(lambda g: g.float() * inv, grads)
        leaves = tensors(grads)
        finite = (torch.stack([torch.isfinite(g).all() for g in leaves]).all()
                  if leaves else torch.ones((), dtype=torch.bool,
                                            device=state.scale.device))
        tracker = torch.where(finite, state.growth_tracker + 1, 0)
        grow = tracker >= self.growth_interval
        new_scale = torch.where(
            finite,
            torch.where(grow, state.scale * self.growth_factor, state.scale),
            state.scale * self.backoff_factor)
        state.growth_tracker.copy_(torch.where(grow, 0, tracker))
        state.scale.copy_(new_scale)
        # zero non-finite grads so a masked optimizer step is a clean no-op
        grads = tree_map(lambda g: torch.where(finite, g, 0.0), grads)
        return grads, state, finite


class NoOpLossScale:
    """The bf16 default: identity scaling (kept for interface parity)."""

    def scale(self, state, loss):
        return loss

    def unscale_and_update(self, state, grads):
        leaves = tensors(grads)
        device = leaves[0].device if leaves else None
        return grads, state, torch.ones((), dtype=torch.bool, device=device)
