"""Train steps from captured CUDA graphs (``tae_tpu_torch.train.step_graphs``)
on the CPU: the mode's rule, and the graphs' bookkeeping with a graph class
of the CUDA graph's interface whose capture runs the step once and puts the
training state back (a capture runs no kernel) and whose replay re-runs the
captured function on the static buffers only: an eager first step, one
capture per key, new keys for a new batch shape or ``accum_iter``, a
learning rate that changes across ``step_lr``'s switch and reaches the
replays, a step under a selective remat policy against eager steps
without remat, launches counted per replay, the graphs dropped by a replaced
parameter or loaded optimizer state; K18's plain version through the
optimizer's host / device split against one eager update; graphed steps of
a tiny TAE against the JAX ``make_train_step``; the eval passes through
``GraphCache`` with tuples in and out; ``--cuda_graphs on`` refused on the
CPU by each of the six drivers. The card's graphs against eager, bit for
bit, are in tests/test_torch_cuda.py.
"""

import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.models.tae import TAE as JTAE
from tae_tpu.models.tae import TAEConfig as JTAEConfig
from tae_tpu.train import TrainState as JTrainState
from tae_tpu.train import adamw as j_adamw
from tae_tpu.train import make_train_step as j_make_train_step
from tae_tpu.train import step_lr as j_step_lr
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu_torch.ckpt import io as ckpt_io
from tae_tpu_torch.ckpt.bridge import state_dict_from_jax
from tae_tpu_torch.models.tae import TAE, TAEConfig
from tae_tpu_torch.ops import cuda
from tae_tpu_torch.serving_graphs import GraphCache, GraphPool, tensors
from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
from tae_tpu_torch.train.step import make_eval_fn, step_graphs_mode
from tae_tpu_torch.utils.dtypes import FP32

# test_torch_train.py's tiny model: 16 tokens, 2 + 2 blocks
TINY = dict(img_size=64, patch_size=16, embed_dim=64, vocab_size=16, depth=2,
            num_heads=1, decoder_embed_dim=128, decoder_depth=2,
            decoder_num_heads=2)
MOMENTS = [None, torch.float32, torch.bfloat16]
MOMENT_IDS = ["fused_adamw", "k18_fp32", "k18_bf16"]


@pytest.fixture(scope="module")
def pair():
    jm = JTAE(JTAEConfig(**TINY))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.key(0)))


def _model(pair) -> TAE:
    jm, params = pair
    tm = TAE(TAEConfig(**TINY), trainable=True)
    tm.load_state_dict(state_dict_from_jax(params, jm.cfg), strict=True)
    return tm


def _imgs(b=4, seed=42):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((b, 3, 64, 64)).astype(np.float32))


def _loss_fn(model, batch):
    return model(batch, policy=FP32, backend="kernel")[0], {}


# ------------------------------------------------------------ the fake graph

def _training_tensors(state) -> list:
    out = [p for p in state.model.parameters()]
    for st in state.opt.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _counting(fn):
    """``fn``, made to mimic a replay's silence: the wrappers' counters as
    they were before it ran."""
    def run():
        before = [w.launches for w in cuda.counted()]
        try:
            return fn()
        finally:
            for w, b in zip(cuda.counted(), before):
                w.launches = b
    return run


def fake_graph_class(*states):
    """A graph class of ``CudaGraph``'s interface on the CPU. ``capture``
    runs ``fn`` once for its output, then puts every tensor of ``states``
    (parameters, optimizer state) back in place as it was: a real capture
    records the step's kernels and runs none of them. ``replay`` re-runs
    ``fn`` on the static buffers it closes over into that output, and as a
    replay of recorded kernels counts no launch itself."""

    class FakeGraph:
        captures = 0

        def __init__(self):
            self.fn = self.out = None

        def capture(self, fn, pool):
            FakeGraph.captures += 1
            kept = [(t, t.detach().clone()) for s in states
                    for t in _training_tensors(s)]
            self.fn = fn
            self.out = fn()
            with torch.no_grad():
                for t, was in kept:
                    t.copy_(was)
            return self.out

        def replay(self):
            new = _counting(self.fn)()
            for dst, src in zip(tensors(self.out), tensors(new)):
                dst.copy_(src)

        def pool(self):
            return "pool"

    return FakeGraph


def _graphed(step, *states):
    """``step``'s graphs, made by a fake graph class over ``states``; the
    graphs are called directly (on the CPU the mode is eager)."""
    cls = fake_graph_class(*states)
    step.graphs.graph_cls = cls
    return step.graphs, cls


def _state(pair, moment_dtype=None, weight_decay=0.05):
    opt = adamw(weight_decay=weight_decay, moment_dtype=moment_dtype)
    return TrainState.create(_model(pair), opt), opt


# ------------------------------------------------------------ the mode

@pytest.mark.parametrize("requested,mode", [(None, False), (False, False)])
def test_the_cpu_steps_eagerly(pair, requested, mode):
    state, opt = _state(pair)
    assert step_graphs_mode(requested, state.model) is mode
    step = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 9),
                           cuda_graphs=requested)
    for it in range(3):
        step(state, _imgs(), it)
    assert step.graphs is None or len(step.graphs) == 0


def test_graphs_on_the_cpu_raise(pair):
    state, opt = _state(pair)
    step = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 9),
                           cuda_graphs=True)
    with pytest.raises(ValueError, match="CUDA device"):
        step(state, _imgs(), 0)
    with pytest.raises(ValueError, match="CUDA device"):
        make_eval_fn(lambda x: x, state.model, True)
    assert make_eval_fn(lambda x: x, state.model).cuda_graphs is False


# ------------------------------------------------------------ the graphs

@pytest.mark.parametrize("moment_dtype", MOMENTS, ids=MOMENT_IDS)
def test_graphs_equal_eager_across_the_lr_switch(pair, moment_dtype):
    """Eager step, capture, replays: each step's loss, lr and gradient
    norm, and after six steps every parameter, moment and step count, equal
    to eager steps bit for bit, the learning rate switching at step 3 (a
    value baked into the graph at its capture would fail here)."""
    state, opt = _state(pair, moment_dtype)
    twin, _ = _state(pair, moment_dtype)
    schedule = step_lr(1e-3, 1e-4, 3)
    step = make_train_step(_loss_fn, opt, schedule, clip_grad=0.05)
    eager = make_train_step(_loss_fn, opt, schedule, clip_grad=0.05,
                            cuda_graphs=False)
    graphs, fake = _graphed(step, state)
    lrs = []
    for it in range(6):
        x = _imgs(seed=it)
        _, got = graphs(state, x, it)
        _, want = eager(twin, x, it)
        assert fake.captures == (0 if it == 0 else 1)
        assert set(got) == {"loss", "lr", "grad_norm"}
        for k in want:
            assert torch.equal(got[k], want[k]), (k, it)
        lrs.append(float(got["lr"]))
    assert lrs == [np.float32(1e-3)] * 3 + [np.float32(1e-4)] * 3
    for a, b in zip(_training_tensors(state), _training_tensors(twin)):
        assert torch.equal(a, b)
    # the groups keep the float outside the step (checkpoints)
    assert all(g["lr"] == 1e-4 for g in state.opt.param_groups)


@pytest.mark.parametrize("remat", ["dots", "dots_no_batch"])
def test_graphed_remat_policies_equal_eager_without_remat(pair, remat):
    """A step under a selective remat policy, captured and replayed: every
    step's metrics and then every parameter and moment equal eager steps
    without remat bit for bit."""
    state, opt = _state(pair)
    twin, _ = _state(pair)
    schedule = step_lr(1e-3, 1e-4, 2)
    step = make_train_step(
        lambda m, b: (m(b, policy=FP32, backend="kernel", remat=remat)[0],
                      {}), opt, schedule)
    eager = make_train_step(_loss_fn, opt, schedule, cuda_graphs=False)
    graphs, fake = _graphed(step, state)
    for it in range(4):
        _, got = graphs(state, _imgs(seed=it), it)
        _, want = eager(twin, _imgs(seed=it), it)
        assert all(torch.equal(got[k], want[k]) for k in want), it
    assert fake.captures == 1
    for a, b in zip(_training_tensors(state), _training_tensors(twin)):
        assert torch.equal(a, b)


def test_one_capture_per_key(pair):
    state, opt = _state(pair)
    step = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 99))
    graphs, fake = _graphed(step, state)
    outs = []
    for it in range(4):
        outs.append(graphs(state, _imgs(seed=it), it)[1]["loss"])
        assert fake.captures == (0 if it == 0 else 1) and len(graphs) == \
            (0 if it == 0 else 1)
    # fresh metrics every step, none the graph's own
    (captured,) = graphs._graphs.values()
    assert len({t.data_ptr() for t in outs + [captured.metrics["loss"]]}) == 5
    graphs(state, _imgs(b=2), 4)                   # a new shape: eager
    assert fake.captures == 1
    graphs(state, _imgs(b=2), 5)                   # then captured
    assert fake.captures == 2 and len(graphs) == 2
    graphs(state, _imgs(), 6)                      # the first key replays
    assert fake.captures == 2
    accum = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 99),
                            accum_iter=2)
    graphs2, fake2 = _graphed(accum, state)
    for it in range(3):
        graphs2(state, _imgs(), it)
    assert fake2.captures == 1 and len(graphs2) == 1


class _Counter:
    """A stand-in wrapper: its ``launches`` as the kernel wrappers'."""
    launches = 0


@pytest.fixture
def counter(monkeypatch):
    _Counter.launches = 0
    real = cuda.counted
    monkeypatch.setattr(cuda, "counted", lambda: real() + (_Counter,))
    return _Counter


def test_launches_counted_per_replay(pair, counter):
    def loss_fn(model, batch):
        _Counter.launches += 3          # three launches a step
        return _loss_fn(model, batch)

    state, opt = _state(pair)
    step = make_train_step(loss_fn, opt, step_lr(1e-3, 1e-4, 99))
    graphs, fake = _graphed(step, state)
    for it in range(4):
        graphs(state, _imgs(), it)
        assert counter.launches == 3 * (it + 1)
    assert fake.captures == 1


def test_a_failed_capture_raises_and_leaves_the_counters(pair, counter):
    def loss_fn(model, batch):
        _Counter.launches += 3
        return _loss_fn(model, batch)

    class Broken:
        def capture(self, fn, pool):
            fn()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    state, opt = _state(pair)
    step = make_train_step(loss_fn, opt, step_lr(1e-3, 1e-4, 99))
    step.graphs.graph_cls = Broken
    step.graphs(state, _imgs(), 0)
    with pytest.raises(RuntimeError, match="capturing"):
        step.graphs(state, _imgs(), 1)
    assert counter.launches == 3


@pytest.mark.parametrize("moment_dtype", [None, torch.bfloat16],
                         ids=["fused_adamw", "k18_bf16"])
def test_replaced_tensors_drop_the_graph(pair, tmp_path, moment_dtype):
    """A replaced parameter, a checkpoint's optimizer state loaded, and
    AdamWMoments.load_state_dict each drop the graph: the next step runs
    eagerly and the one after captures again. A change in place keeps it."""
    state, opt = _state(pair, moment_dtype)
    step = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 99))
    graphs, fake = _graphed(step, state)
    it = iter(range(100))

    def two_steps(captures):
        graphs(state, _imgs(), next(it))
        assert fake.captures == captures - 1 and len(graphs) == 0
        graphs(state, _imgs(), next(it))
        assert fake.captures == captures and len(graphs) == 1

    graphs(state, _imgs(), next(it))
    graphs(state, _imgs(), next(it))
    assert fake.captures == 1
    with torch.no_grad():
        state.model.norm.weight.mul_(1.0)          # in place: kept
    graphs(state, _imgs(), next(it))
    assert fake.captures == 1 and len(graphs) == 1
    state.model.norm.bias = torch.nn.Parameter(
        state.model.norm.bias.detach().clone())     # replaced
    two_steps(2)
    path = tmp_path / "ckpt"
    ckpt_io.save_checkpoint(path, state, step=1)
    ckpt_io.load_train_state(path, state.model, state.opt)
    two_steps(3)
    state.opt.load_state_dict(state.opt.state_dict())
    two_steps(4)


@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_k18_plain_version_through_the_split(pair, moment_dtype):
    """AdamWMoments' update bound once (the gradients at fixed addresses,
    as a graph holds them), its host part and device part run for three
    steps: parameters, moments and counts equal to three eager updates bit
    for bit."""
    rng = np.random.default_rng(7)
    split, opt = _state(pair, moment_dtype)
    eager, _ = _state(pair, moment_dtype)
    params = list(split.model.parameters())
    grads = [[torch.from_numpy((0.1 * rng.standard_normal(p.shape))
                               .astype(np.float32)) for p in params]
             for _ in range(3)]
    lrs = [1e-3, 1e-3, 1e-4]
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.update(split.opt, 0.0)          # the state made, as an eager step
    eager_params = list(eager.model.parameters())
    for p in eager_params:
        p.grad = torch.zeros_like(p)
    opt.update(eager.opt, 0.0)
    plan = opt.bind(split.opt)
    for k in range(3):
        for p, g in zip(params, grads[k]):
            p.grad.copy_(g)
        opt.host(split.opt, lrs[k], plan)
        opt.apply(split.opt, plan)
        for p, g in zip(eager_params, grads[k]):
            p.grad = g.clone()
        opt.update(eager.opt, lrs[k])
    for a, b in zip(_training_tensors(split), _training_tensors(eager)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {float(st["step"]) for st in split.opt.state.values()} == {4.0}


@pytest.mark.parametrize("accum_iter,clip_grad", [(1, None), (2, 0.05)])
def test_graphed_steps_match_jax(pair, accum_iter, clip_grad):
    """Three steps (eager, capture, replay) against the JAX step, at
    tests/test_torch_train.py::test_three_train_steps_match_jax's
    tolerances; the learning rate switches at the replay."""
    from tests.test_torch_train import _stack, _unstack

    jm, params = pair
    j_opt = j_adamw(weight_decay=0.05)
    j_step = jax.jit(j_make_train_step(
        lambda p, b: (jm.forward(_stack(p), b, policy=J_FP32)[0], {}), j_opt,
        j_step_lr(1e-3, 1e-4, 2), accum_iter=accum_iter, clip_grad=clip_grad))
    start = state_dict_from_jax(params, jm.cfg)
    j_state = JTrainState.create(
        jax.tree.map(jnp.asarray, _unstack(params)), j_opt)
    state, opt = _state(pair)
    step = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 2),
                           accum_iter=accum_iter, clip_grad=clip_grad)
    graphs, fake = _graphed(step, state)
    for it in range(3):
        imgs = _imgs(4, seed=it).numpy()
        j_state, j_metrics = j_step(j_state, jnp.asarray(imgs), jnp.int32(it))
        _, metrics = graphs(state, torch.from_numpy(imgs), it)
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), float(j_metrics[k]),
                                       rtol=2e-4, err_msg=f"{k} at {it}")
    assert fake.captures == 1
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_state.params),
                               jm.cfg)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose((p.detach() - start[k]).numpy(),
                                   (want[k] - start[k]).numpy(),
                                   atol=5e-5, rtol=5e-3, err_msg=k)


# ------------------------------------------------------------ eval passes

def test_eval_cache_takes_tuples(pair):
    """The drivers' eval functions take (images, targets) and return
    several tensors: the cache keys on every input's shape, copies each
    into its static buffer and returns fresh copies of each output."""
    model = _model(pair)

    class Fake:
        def capture(self, fn, pool):
            self.fn, self.out = fn, fn()
            return self.out

        def replay(self):
            new = self.fn()
            for dst, src in zip(tensors(self.out), tensors(new)):
                dst.copy_(src)

        def pool(self):
            return "pool"

    def work(args):
        x, t = args
        return x.sum(dim=1), (x * t[:, None]).mean()

    cache = GraphCache(graph_cls=Fake)
    for i in range(3):
        x, t = torch.rand(4, 3, generator=torch.Generator().manual_seed(i)), \
            torch.arange(4.0) + i
        got = cache(model, ("eval", 4), work, (x, t))
        want = work((x, t))
        assert isinstance(got, tuple) and all(
            torch.equal(a, b) for a, b in zip(got, want))
    assert len(cache) == 1


def _pooled(cls):
    """``cls`` made to record the pool each capture is given, and to name
    its own pool after itself."""
    class Pooled(cls):
        given = []
        made = 0

        def __init__(self):
            super().__init__()
            self.number = Pooled.made
            Pooled.made += 1

        def capture(self, fn, pool):
            Pooled.given.append(pool)
            return super().capture(fn, pool)

        def pool(self):
            return f"pool of graph {self.number}"

    return Pooled


def test_step_and_eval_graphs_share_one_pool(pair):
    """A driver's train step and eval pass given one GraphPool: the step's
    capture makes the pool, the eval's captures into it."""
    state, opt = _state(pair)
    pool = GraphPool()
    step = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 99), pool=pool)
    graphs, fake = _graphed(step, state)
    cls = graphs.graph_cls = _pooled(fake)
    for it in range(3):
        graphs(state, _imgs(), it)
    cache = GraphCache(graph_cls=cls, pool=pool)
    for _ in range(3):
        cache(state.model, "eval", lambda x: state.model(
            x, policy=FP32, backend="kernel")[0], _imgs(b=8))
    assert cls.given == [None, "pool of graph 0"]
    assert len(graphs) == 1 and len(cache) == 1
    # eager steps leave the pool alone: a second step function of its own
    other = make_train_step(_loss_fn, opt, step_lr(1e-3, 1e-4, 99))
    assert other.graphs.pool is not pool


def test_a_pool_whose_graphs_are_gone_is_not_reused():
    """A pool is captured into again only while one of its graphs lives
    (the allocator frees a pool once no graph holds it): after every graph
    is dropped, the next capture makes a new pool."""
    class Graph:
        def capture(self, fn, pool):
            return fn()

    cls = _pooled(Graph)
    pool = GraphPool()
    first = cls()
    pool.capture(first, lambda: None)
    second = cls()
    pool.capture(second, lambda: None)
    assert cls.given == [None, "pool of graph 0"]
    del first
    third = cls()
    pool.capture(third, lambda: None)       # the second still holds it
    assert cls.given[-1] == "pool of graph 0"
    del second, third
    gc.collect()
    pool.capture(cls(), lambda: None)
    assert cls.given[-1] is None


# ------------------------------------------------------------ the drivers

def _driver_args(name, tmp_path):
    from tests.test_torch_downstream_cli import (CLS, CLS_KW, ENCODER, SEG,
                                                 SEG_KW)

    tae = ["--model", "tae_patch16_vocab16_px256", "--model_args",
           json.dumps(dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
                           decoder_embed_dim=64, decoder_depth=2,
                           decoder_num_heads=4)), "--input_size", "64",
           "--num_workers", "0"]
    return {
        "train": tae + ["--output_dir", str(tmp_path)],
        "evaluate": tae + ["--output_dir", str(tmp_path)],
        "encode": tae + ["--output_dir", str(tmp_path), "--data_path",
                         str(tmp_path / "none-000000.tar")],
        "train_recognition_in19k": ["--model", CLS, "--model_args",
                                    json.dumps(CLS_KW), "--num_classes", "7",
                                    *ENCODER, "--output_dir", str(tmp_path)],
        "train_recognition_in1k": ["--model", CLS, "--model_args",
                                   json.dumps(CLS_KW), "--num_classes", "3",
                                   *ENCODER, "--output_dir", str(tmp_path)],
        "train_segmentation": ["--model", SEG, "--model_args",
                               json.dumps(SEG_KW), *ENCODER,
                               "--output_dir", str(tmp_path)],
    }[name]


@pytest.mark.parametrize("name", ["train", "evaluate", "encode",
                                  "train_recognition_in19k",
                                  "train_recognition_in1k",
                                  "train_segmentation"])
def test_drivers_refuse_graphs_on_the_cpu(name, tmp_path, capsys):
    import importlib

    driver = importlib.import_module(f"tae_tpu_torch.cli.{name}")
    parser = driver.get_args_parser()
    assert parser.parse_args([]).cuda_graphs == "auto"
    args = parser.parse_args(_driver_args(name, tmp_path)
                             + ["--device", "cpu", "--cuda_graphs", "on"])
    with pytest.raises(SystemExit, match="--cuda_graphs on: .*CUDA device"):
        driver.main(args)
