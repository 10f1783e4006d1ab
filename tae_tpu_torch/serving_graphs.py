"""Serving requests from captured CUDA graphs: the port's counterpart of the
``jax.jit`` cache of the JAX ``Tokenizer`` (``tae_tpu/tokenizer.py`` jits
encode and decode, one compiled program per request shape).

A :class:`GraphCache` belongs to one ``Tokenizer``. It keys a request on
everything that changes the captured work (the ``Tokenizer`` passes the
entry, the input's shape and dtype, the backend, the policy and the route
switches ``attn_q8`` / ``qkv_q8``) and serves a key in three steps:

1. The first request runs eagerly and returns its result. That builds the
   kernel library at first use, creates cuBLAS's handles and runs the C
   launchers' ``cudaFuncSetAttribute`` calls, none of which may happen
   under capture.
2. The second copies its input into a static buffer, captures the entry's
   device work on that buffer into a graph, and replays it.
3. Later requests copy their input into the static buffer and replay.

Every request returns a copy of the graph's output, as ``jit`` returns fresh
arrays. The copy of a host input to the card stays outside the graph: the
caller moves the input before it hands it over.

**Memory.** All graphs of a cache share one memory pool (the first
capture's). A graph keeps its static input (allocated outside the pool),
its static output and, in the pool, the memory its work allocated and freed
(the per-call workspaces of K4, K5, K13 and K14 included), until
:meth:`GraphCache.reset` or the cache is dropped. Graphs of one pool may
replay in any order here: a graph reads only its static input and the
model's tensors, both allocated outside the pool, and its output is copied
out right after its replay on the same stream, before another graph can
reuse that memory.

**Capture mode.** ``capture_error_mode="thread_local"``: only the capturing
thread's CUDA calls are checked, so a pinned allocation or a copy made by
another thread (a loader's) cannot break a capture, as it could in the
default global mode; an unsafe call in the capturing thread still raises,
where ``"relaxed"`` would let it through.

**Launch counters.** A capture records the kernels and runs none, while the
wrappers count their launches as they are called. So the counters' delta
during a capture is taken and undone, and each replay adds it again: a
request counts exactly one request's launches, eager or replayed. What a
replay adds is the capture's record, not a count taken at a launch;
``chip_smoke.py`` reads the kernel nodes of every graph it serves
(:meth:`CudaGraph.raw`) and holds them, by name and count, against the
kernels of the same request run eagerly under ``torch.profiler``, whose
launches the wrappers count.

**A model changed under the graphs.** A graph replays the addresses it was
captured with. Before each request the cache compares every parameter,
buffer and submodule of the model with those at capture time, by identity
and by device address; one replaced (by assignment, ``.data =``, a move)
drops every graph, and the cache starts again from step 1. A change in
place (``copy_``, ``load_state_dict``) keeps the addresses and is what the
next replay reads. Other changes of what the work does (a module's
``block_h``) need :meth:`GraphCache.reset`.
"""

from __future__ import annotations

import dataclasses

import torch

CAPTURE_MODE = "thread_local"


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the interface :class:`GraphCache`
    uses: ``capture(fn, pool)`` records ``fn()`` and returns its output,
    ``replay()``, ``pool()``; ``raw()``, the captured ``cudaGraph_t``,
    kept beside its instantiation (in host memory) so that what a replay
    runs can be read from its nodes."""

    def __init__(self):
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)

    def capture(self, fn, pool):
        with torch.cuda.graph(self._graph, pool=pool,
                              capture_error_mode=CAPTURE_MODE):
            out = fn()
        self._graph.instantiate()
        return out

    def raw(self) -> int:
        return self._graph.raw_cuda_graph()

    def replay(self) -> None:
        self._graph.replay()

    def pool(self):
        return self._graph.pool()


@dataclasses.dataclass
class _Captured:
    graph: object
    static_in: torch.Tensor
    out: torch.Tensor
    launches: list          # (wrapper, its launches a request)


def _snapshot(model: torch.nn.Module) -> list:
    """(dict, key, value, device address) of every parameter, buffer and
    submodule of ``model``."""
    snap = []
    for mod in model.modules():
        for d in (mod._parameters, mod._buffers, mod._modules):
            for k, v in d.items():
                ptr = v.data_ptr() if isinstance(v, torch.Tensor) else None
                snap.append((d, k, v, ptr))
    return snap


def _unchanged(snap: list) -> bool:
    for d, k, v, ptr in snap:
        if d.get(k) is not v or (ptr is not None and v.data_ptr() != ptr):
            return False
    return True


class GraphCache:
    """Captured graphs of one model's serving entries, by key (see the
    module's docstring). ``graph_cls`` makes a graph; tests pass one that
    runs on the CPU."""

    def __init__(self, graph_cls=CudaGraph):
        self.graph_cls = graph_cls
        self.reset()

    def reset(self) -> None:
        """Drop every graph and its memory; each key starts again with an
        eager request."""
        self._graphs: dict = {}
        self._seen: set = set()
        self._pool = None
        self._model = None
        self._snap: list = []

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, model: torch.nn.Module, key, fn, x: torch.Tensor):
        """``fn(x)`` for request ``key`` of ``model``: eager on the key's
        first request, else a replay of its graph (captured on the second);
        a fresh tensor either way. ``x`` is on the card already."""
        if self._graphs and (model is not self._model
                             or not _unchanged(self._snap)):
            self.reset()
        captured = self._graphs.get(key)
        if captured is None:
            if key not in self._seen:
                self._seen.add(key)
                return fn(x)
            captured = self._capture(model, fn, x)
            self._graphs[key] = captured
        captured.static_in.copy_(x)
        captured.graph.replay()
        for wrapper, n in captured.launches:
            wrapper.launches += n
        return captured.out.clone()

    def _capture(self, model, fn, x: torch.Tensor) -> _Captured:
        from tae_tpu_torch.ops.cuda import counted

        static_in = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        static_in.copy_(x)
        wrappers = counted()
        before = [w.launches for w in wrappers]
        graph = self.graph_cls()
        try:
            out = graph.capture(lambda: fn(static_in), self._pool)
            launches = [(w, w.launches - b) for w, b in zip(wrappers, before)
                        if w.launches != b]
        finally:
            for w, b in zip(wrappers, before):
                w.launches = b
        if self._pool is None:
            self._pool = graph.pool()
        if self._model is None:
            self._model, self._snap = model, _snapshot(model)
        return _Captured(graph, static_in, out, launches)


def graphs_mode(requested: bool | None, device: torch.device,
                sharded: bool) -> bool:
    """Whether a ``Tokenizer`` serves from graphs: ``requested`` as given,
    None meaning on for a model on a CUDA ``device`` that is not
    ``sharded`` (by ``fully_shard`` or the tensor split; as ``jit`` is
    always on in the JAX package). True on another device or on a sharded
    model raises."""
    if requested is None:
        return device.type == "cuda" and not sharded
    if requested and device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a model on a CUDA device; "
                         f"this one is on {device}")
    if requested and sharded:
        raise ValueError("cuda_graphs=True: the model is sharded (by "
                         "fully_shard or the tensor split), whose forward "
                         "runs collectives of every rank that a graph "
                         "cannot capture; serve it eagerly")
    return bool(requested)
