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
caller moves the input before it hands it over. An input or an output may
be one tensor or a tuple, list or dict of them (the drivers' eval passes
take images and targets and return several per-sample values).

**Memory.** All graphs of a cache share one memory pool (a
:class:`GraphPool`: the first capture's, or one the cache is given and
shares with other graphs, as a driver's train step and eval pass share
theirs). A graph keeps its static input (allocated outside the pool), its
static output and, in the pool, the memory its work allocated and freed
(the per-call workspaces of K4, K5, K13 and K14 included), until
:meth:`GraphCache.reset` or the cache is dropped. Graphs of one pool may
replay in any order here: a graph reads only its static input, the model's
tensors and the tensors it keeps alive (its output, a train step's
gradients), none of which another capture can take, and its output is
copied out right after its replay on the same stream, before another graph
can reuse the memory its work freed.

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
import weakref

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


class GraphPool:
    """The memory pool of the graphs captured into it: made by the first
    capture, and shared by the later ones for as long as one of the graphs
    that hold it is alive (a pool whose graphs are all gone is not captured
    into again; the next capture makes a new one)."""

    def __init__(self):
        self._handle = None
        self._graphs: weakref.WeakSet = weakref.WeakSet()

    def capture(self, graph, fn):
        """``graph.capture(fn, pool)`` into this pool; ``fn()``'s output."""
        handle = self._handle if len(self._graphs) else None
        out = graph.capture(fn, handle)
        self._handle = handle if handle is not None else graph.pool()
        self._graphs.add(graph)
        return out


@dataclasses.dataclass
class _Captured:
    graph: object
    static_in: object       # a tensor, or a tuple / list / dict of them
    out: object
    launches: list          # (wrapper, its launches a request)


def tree_map(fn, tree):
    """``fn`` on every tensor of ``tree`` (a tensor, or tuples, lists and
    dicts of them); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tensors(tree) -> list:
    """The tensors of ``tree``, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def signature(tree):
    """What a graph of ``tree``'s consumer depends on: the structure, each
    tensor's shape, dtype and device, and every other leaf's value."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, *(signature(v) for v in tree))
    return tree


def static_copy(tree):
    """Buffers of ``tree``'s shapes and dtypes, filled with it."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device=x.device).copy_(x), tree)


def copy_into(static, tree) -> None:
    for dst, src in zip(tensors(static), tensors(tree)):
        dst.copy_(src)


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
    module's docstring). ``pool``: a :class:`GraphPool` shared with other
    graphs (None: the cache's own). ``graph_cls`` makes a graph; tests pass
    one that runs on the CPU."""

    def __init__(self, graph_cls=CudaGraph, pool: GraphPool | None = None):
        self.graph_cls = graph_cls
        self.pool = pool if pool is not None else GraphPool()
        self.reset()

    def reset(self) -> None:
        """Drop every graph and its memory; each key starts again with an
        eager request."""
        self._graphs: dict = {}
        self._seen: set = set()
        self._model = None
        self._snap: list = []

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, model: torch.nn.Module, key, fn, x):
        """``fn(x)`` for request ``key`` of ``model``: eager on the key's
        first request, else a replay of its graph (captured on the second);
        fresh tensors either way. ``x`` (a tensor or a tuple / list / dict
        of them) is on the card already."""
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
        copy_into(captured.static_in, x)
        captured.graph.replay()
        add_launches(captured.launches)
        return tree_map(torch.clone, captured.out)

    def _capture(self, model, fn, x) -> _Captured:
        static_in = static_copy(x)
        graph = self.graph_cls()
        out, launches = capture_counted(graph, lambda: fn(static_in),
                                        self.pool)
        if self._model is None:
            self._model, self._snap = model, _snapshot(model)
        return _Captured(graph, static_in, out, launches)


def capture_counted(graph, fn, pool: GraphPool):
    """``pool.capture(graph, fn)``'s output and the launches the wrappers
    counted while ``fn`` was captured, as ``(wrapper, launches)`` pairs;
    the counters are left as they were before the capture (a capture runs
    no kernel)."""
    from tae_tpu_torch.ops.cuda import counted

    wrappers = counted()
    before = [w.launches for w in wrappers]
    try:
        out = pool.capture(graph, fn)
        launches = [(w, w.launches - b) for w, b in zip(wrappers, before)
                    if w.launches != b]
    finally:
        for w, b in zip(wrappers, before):
            w.launches = b
    return out, launches


def add_launches(launches: list) -> None:
    """A replay's launches, ``(wrapper, launches)`` pairs, added to the
    wrappers' counters."""
    for wrapper, n in launches:
        wrapper.launches += n


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
