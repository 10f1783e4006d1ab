"""Train steps from captured CUDA graphs: the port's counterpart of the JAX
drivers' ``jax.jit(make_train_step(...), donate_argnums=(0,))``
(``tae_tpu/cli/train.py``), which compiles forward, backward, gradient
accumulation, clipping, AdamW and the metric scalars into one program.

:class:`StepGraphs` holds the graphs of one step function
(:func:`tae_tpu_torch.train.step.make_train_step`, whose ``accum_iter``,
``clip_grad`` and loss function, with its backend and ``remat``, are fixed
when it is made). It keys a step on the model and optimizer it updates and
the batch's structure, shapes and dtypes, and runs a key in three steps, as
:mod:`tae_tpu_torch.serving_graphs` serves a request:

1. The first step runs eagerly. That builds the kernel library, creates
   cuBLAS's handles, runs the C launchers' ``cudaFuncSetAttribute`` calls
   and makes the optimizer's state (its moments), none of which may happen
   under capture.
2. The second copies the batch into static buffers, captures the step's
   device part on them, and replays it.
3. Later steps copy the batch in and replay.

**Host and device.** A step's work splits where the optimizer's does
(:mod:`tae_tpu_torch.train.optim`): the host part (the learning rate from
the schedule, the step counts, K18's scalars) runs before every replay and
writes what the graph reads, by copies on the stream outside the graph; the
device part (zeroing the gradients by setting them to None, the forward and
backward of every microbatch, the division by ``accum_iter``, the norm, the
clipping, the update, the metrics) is what the graph holds. The gradients
are None when the capture starts, so backward allocates them in the graph's
pool, where every replay writes them again. The metrics come back as fresh
0-dim tensors, ``lr`` a copy of the optimizer's learning-rate tensor that the
host part wrote.

**Launch counters** as in :class:`~tae_tpu_torch.serving_graphs.GraphCache`:
the capture's counts are undone and each replay adds them again.

**What drops a graph.** A graph replays the addresses it captured. Before
each step the graph's snapshot of the model (every parameter, buffer and
submodule) and of the optimizer's state (its state dict, each parameter's
state and every tensor in it) is compared, by identity and address; one
replaced (``load_train_state``, ``AdamWMoments.load_state_dict``,
``set_adamw_state``, an assignment) drops every graph of that model and
optimizer, and its keys start again with an eager step. Changes in place
(``copy_``, a model's ``load_state_dict``) are what the next replay reads.
Other modules the loss function reads (a frozen encoder) are not in the
snapshot: replacing their tensors needs :meth:`StepGraphs.reset`.

**Memory.** All graphs of one step function share one pool (a
:class:`~tae_tpu_torch.serving_graphs.GraphPool`, which a driver also gives
its eval pass). A graph keeps its static batch (allocated outside the pool),
its metrics, its optimizer plan (K18's table) and, in the pool, the
activations, gradients and workspaces of its step, until it is dropped.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from tae_tpu_torch.serving_graphs import (CudaGraph, GraphPool, _snapshot,
                                          _unchanged, add_launches,
                                          capture_counted, copy_into,
                                          signature, static_copy, tree_map)


@dataclasses.dataclass
class _Captured:
    graph: object
    static: object          # the batch's buffers
    metrics: dict
    plan: object            # the optimizer's plan, bound in the capture
    launches: list          # (wrapper, its launches a step)
    snap: list


def _state_snapshot(opt: torch.optim.Optimizer) -> list:
    """(dict, key, value, device address) of the optimizer's state: the
    state dict itself, each parameter's state and every tensor in it."""
    snap = [(opt.__dict__, "state", opt.state, None)]
    for p, st in opt.state.items():
        snap.append((opt.state, p, st, None))
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                snap.append((st, k, v, v.data_ptr()))
    return snap


class StepGraphs:
    """Captured graphs of one train step function (see the module's
    docstring). ``device_step(state, batch, plan=None, host=None) ->
    (metrics, plan)`` is the step's device part (``host(plan)``, where
    given, is called between the optimizer's bind and its update: the
    eager step's host part); ``optimizer`` the :class:`Optimizer` pair
    whose ``host`` runs before each replay. ``pool``: a
    :class:`~tae_tpu_torch.serving_graphs.GraphPool` shared with other
    graphs (None: their own). ``graph_cls`` makes a graph; tests pass one
    that runs on the CPU."""

    def __init__(self, device_step, optimizer, schedule,
                 pool: GraphPool | None = None, graph_cls=CudaGraph):
        self.device_step = device_step
        self.optimizer = optimizer
        self.schedule = schedule
        self.pool = pool if pool is not None else GraphPool()
        self.graph_cls = graph_cls
        self.reset()

    def reset(self) -> None:
        """Drop every graph and its memory; each key starts again with an
        eager step."""
        self._graphs: dict = {}
        # key -> (model, optimizer) weakly: an id that a new object reuses
        # is not the key seen before
        self._seen: dict = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def graphs(self, state) -> dict:
        """The graphs of ``state``'s model and optimizer, by key."""
        ids = (id(state.model), id(state.opt))
        return {k: c for k, c in self._graphs.items() if k[:2] == ids}

    def drop(self, state) -> None:
        """Drop the graphs of ``state``'s model and optimizer; their keys
        start again with an eager step."""
        ids = (id(state.model), id(state.opt))
        for table in (self._graphs, self._seen):
            for k in [k for k in table if k[:2] == ids]:
                del table[k]

    def __call__(self, state, batch, it: int):
        model, opt = state.model, state.opt
        key = (id(model), id(opt), signature(batch))
        captured = self._graphs.get(key)
        if captured is not None and not _unchanged(captured.snap):
            self.drop(state)
            captured = None
        lr = self.schedule(it)
        if captured is None:
            refs = self._seen.get(key)
            if refs is None or refs[0]() is not model or refs[1]() is not opt:
                self._seen[key] = (weakref.ref(model), weakref.ref(opt))
                metrics, _ = self.device_step(
                    state, batch,
                    host=lambda plan: self.optimizer.host(opt, lr, plan))
                return state, metrics
            captured = self._capture(state, batch)
            self._graphs[key] = captured
        copy_into(captured.static, batch)
        self.optimizer.host(opt, lr, captured.plan)
        captured.graph.replay()
        add_launches(captured.launches)
        return state, tree_map(torch.clone, captured.metrics)

    def _capture(self, state, batch) -> _Captured:
        static = static_copy(batch)
        # the eager step's gradients go before the capture: backward makes
        # the graph's own in its pool
        state.opt.zero_grad(set_to_none=True)
        holder: dict = {"plan": None}

        def run():
            # a real capture runs this once; a replay runs none of it
            metrics, holder["plan"] = self.device_step(state, static,
                                                       plan=holder["plan"])
            return metrics

        graph = self.graph_cls()
        metrics, launches = capture_counted(graph, run, self.pool)
        snap = _snapshot(state.model) + _state_snapshot(state.opt)
        return _Captured(graph, static, metrics, holder["plan"], launches,
                         snap)
