"""The Tokenizer's serving from captured CUDA graphs
(``tae_tpu_torch.serving_graphs``) on the CPU: the mode's rule (eager by
default off a CUDA device, ``cuda_graphs=True`` raising there and on a
sharded model), and the cache's bookkeeping with a graph class of the
CUDA graph's interface whose replay re-runs the captured function on the
static input: one capture per key, new captures when the shape, dtype,
backend or a route switch changes, an eager first request, a fresh tensor
per request, one request's launches counted per replay, the graphs dropped
by ``reset_graphs()`` and when the model's tensors are replaced. A tiny
model served through that cache is held against the JAX ``Tokenizer``
(the port's plain versions; the JAX side as tests/test_torch_tokenizer.py
runs it). The card's graphs against eager, bit for bit, are in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.torch_export import tae_state_dict
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ops import cuda
from tae_tpu_torch.serving_graphs import GraphCache, graphs_mode
from tae_tpu_torch.tokenizer import Tokenizer, set_attn_q8, set_qkv_q8
from tae_tpu_torch.utils.dtypes import Policy

NAME = "tae_patch16_vocab16_px256"
TINY = dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=48, decoder_depth=2, decoder_num_heads=4)
# tests/test_torch_tokenizer.py's bound: bf16 end to end, different
# rounding points over two blocks per half
BF16_REL = 2e-2
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def counting(fn):
    """``fn``, made to mimic a graph replay's silence: the wrappers'
    counters as they were before it ran."""
    def run():
        before = [w.launches for w in cuda.counted()]
        try:
            return fn()
        finally:
            for w, b in zip(cuda.counted(), before):
                w.launches = b
    return run


class FakeGraph:
    """The interface of ``serving_graphs.CudaGraph`` on the CPU: capture
    runs ``fn`` once for its output (a real capture runs its Python, the
    wrappers counting their launches, and records the kernels), replay
    re-runs ``fn`` on the static input into that output and, as a replay of
    recorded kernels, counts no launch itself."""
    captures = 0

    def __init__(self):
        self.fn = self.out = None

    def capture(self, fn, pool):
        FakeGraph.captures += 1
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        self.out.copy_(counting(self.fn)())

    def pool(self):
        return "pool"


@pytest.fixture
def fake_graphs():
    FakeGraph.captures = 0
    return FakeGraph


def _rel(got, want) -> float:
    g = np.asarray(got.float()) if isinstance(got, torch.Tensor) else \
        np.array(jnp.asarray(got, jnp.float32))
    w = np.array(jnp.asarray(want, jnp.float32))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def pair():
    """The JAX Tokenizer and the port's on the same bf16 weights."""
    jm = jmodels.create(NAME, **TINY)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jtok = JTokenizer(model=jm, params=jparams,
                      policy=JPolicy(jnp.bfloat16, jnp.bfloat16))
    tm = models.create(NAME, **TINY)
    tm.load_state_dict(tae_state_dict(params, jm.cfg), strict=True)
    return jtok, tm.to(torch.bfloat16).eval()


def _served(model, **kw):
    """A Tokenizer of ``model`` whose cache makes FakeGraphs."""
    tok = Tokenizer(model=model, policy=Policy(torch.bfloat16, torch.bfloat16),
                    **kw)
    tok._graphs = GraphCache(graph_cls=FakeGraph)
    return tok


def _images(b: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, 3, 64, 64),
                                                dtype=np.uint8)


# ------------------------------------------------------------ the mode

def test_cuda_graphs_true_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        Tokenizer.from_checkpoint(NAME, device="cpu", cuda_graphs=True, **TINY)
    model = models.create(NAME, **TINY)
    with pytest.raises(ValueError, match="CUDA device"):
        Tokenizer(model=model, policy=Policy(), cuda_graphs=True)


@pytest.mark.parametrize("requested", [None, False])
def test_the_cpu_serves_eagerly(requested):
    tok = Tokenizer.from_checkpoint(NAME, device="cpu", cuda_graphs=requested,
                                    **TINY)
    assert tok.cuda_graphs is False and tok._graphs is None
    z = tok.encode(_images(1))
    assert z.shape == (1, 16, 16)


@pytest.mark.parametrize("requested,device,sharded,mode", [
    (None, CUDA, False, True), (None, CUDA, True, False),
    (None, CPU, False, False), (False, CUDA, False, False),
    (True, CUDA, False, True)])
def test_graphs_mode_rule(requested, device, sharded, mode):
    assert graphs_mode(requested, device, sharded) is mode


@pytest.mark.parametrize("device,sharded,why", [
    (CPU, False, "CUDA device"), (CUDA, True, "fully_shard")])
def test_graphs_mode_refuses(device, sharded, why):
    with pytest.raises(ValueError, match=why):
        graphs_mode(True, device, sharded)


# ------------------------------------------------------------ the cache

class _Counter:
    """A stand-in wrapper: its ``launches`` as the kernel wrappers'."""
    launches = 0


@pytest.fixture
def counter(monkeypatch):
    _Counter.launches = 0
    real = cuda.counted
    monkeypatch.setattr(cuda, "counted", lambda: real() + (_Counter,))
    return _Counter


def _work(x):
    """A request's device work: three launches of the stand-in."""
    _Counter.launches += 3
    return x * 2 + 1


def test_cache_eager_then_capture_then_replay(fake_graphs, counter):
    cache, model = GraphCache(graph_cls=FakeGraph), torch.nn.Linear(2, 2)
    x = torch.arange(6.0).reshape(2, 3)
    outs = []
    for i in range(4):
        outs.append(cache(model, "k", _work, x + i))
        assert torch.equal(outs[-1], (x + i) * 2 + 1)
        # one request's launches a request: eager, capture, replay alike
        assert counter.launches == 3 * (i + 1)
        assert fake_graphs.captures == (0 if i == 0 else 1)
        assert len(cache) == (0 if i == 0 else 1)
    # every request a fresh tensor, none the graph's own output
    static = cache._graphs["k"].out
    assert len({o.data_ptr() for o in outs + [static]}) == 5
    outs[-1].zero_()
    assert torch.equal(cache(model, "k", _work, x), x * 2 + 1)


def test_cache_reset_and_a_replaced_parameter(fake_graphs, counter):
    cache, model = GraphCache(graph_cls=FakeGraph), torch.nn.Linear(2, 2)
    x = torch.ones(3)
    for _ in range(3):
        cache(model, "k", _work, x)
    assert fake_graphs.captures == 1
    with torch.no_grad():
        model.weight.copy_(torch.zeros(2, 2))     # in place: graphs stay
    cache(model, "k", _work, x)
    assert len(cache) == 1 and fake_graphs.captures == 1
    model.weight = torch.nn.Parameter(torch.zeros(2, 2))   # replaced
    cache(model, "k", _work, x)                   # eager again
    assert len(cache) == 0 and fake_graphs.captures == 1
    cache(model, "k", _work, x)
    assert len(cache) == 1 and fake_graphs.captures == 2
    model.bias.data = torch.zeros(2)              # another address
    cache(model, "k", _work, x)
    assert len(cache) == 0
    cache(model, "k", _work, x)
    cache.reset()
    assert len(cache) == 0
    cache(model, "k", _work, x)                   # eager after a reset
    assert len(cache) == 0 and fake_graphs.captures == 3
    assert counter.launches == 3 * 9


def test_a_failed_capture_leaves_the_counters(counter):
    class Broken(FakeGraph):
        def capture(self, fn, pool):
            fn()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    cache, model = GraphCache(graph_cls=Broken), torch.nn.Linear(2, 2)
    cache(model, "k", _work, torch.ones(1))
    with pytest.raises(RuntimeError, match="capturing"):
        cache(model, "k", _work, torch.ones(1))
    assert counter.launches == 3


# ------------------------------------------------ the Tokenizer's keys

def test_tokenizer_keys(pair, fake_graphs):
    _, model = pair
    tok = _served(model)
    u8, f32 = _images(2), np.random.default_rng(1).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    steps = [
        (lambda: tok.encode(u8), 0, 1),        # eager, capture
        (lambda: tok.encode(u8), 1, 1),        # replay
        (lambda: tok.encode(_images(1)), 1, 2),   # another shape
        (lambda: tok.encode(f32), 2, 3),       # another dtype
    ]
    for fn, before, after in steps:
        fn()
        assert fake_graphs.captures == before
        fn()
        assert fake_graphs.captures == after
    tok.backend = "reference"                  # assigned, as cli.encode does
    tok.encode(u8)
    tok.encode(u8)
    assert fake_graphs.captures == 4
    for switch in (lambda: set_attn_q8(model, False),
                   lambda: set_qkv_q8(model, True)):
        switch()
        tok.encode(u8)
        tok.encode(u8)
    assert fake_graphs.captures == 6 and len(tok._graphs) == 6
    set_attn_q8(model, None)
    set_qkv_q8(model, False)
    tok.backend = None
    tok.encode(u8)                             # the first key again: a replay
    assert fake_graphs.captures == 6
    tok.reset_graphs()
    assert len(tok._graphs) == 0


def test_tokenizer_through_the_cache_matches_jax(pair, fake_graphs):
    """Latents and reconstructions served from the (fake) graphs: equal to
    the eager Tokenizer's and within BF16_REL of the JAX Tokenizer's."""
    jtok, model = pair
    tok, eager = _served(model), Tokenizer(
        model=model, policy=Policy(torch.bfloat16, torch.bfloat16))
    x = _images(2, seed=11)
    for _ in range(3):                         # eager, capture, replay
        z, rec = tok.encode(x), tok.decode(tok.encode(x))
        assert torch.equal(z, eager.encode(x))
        assert torch.equal(rec, eager.decode(z))
        assert _rel(z, jtok.encode(x)) < BF16_REL
        assert _rel(rec, jtok.decode(jtok.encode(x))) < BF16_REL
    assert fake_graphs.captures == 2


def test_discrete_entries_through_the_cache(fake_graphs):
    model = models.create(NAME, quantize=True, codebook_size=32, **TINY)
    model.init_weights_(torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16).eval()
    with torch.no_grad():      # codes on the latents' scale: no near-ties
        z = Tokenizer(model=model, policy=Policy(torch.bfloat16,
                                                 torch.bfloat16)).encode(
            _images(4, seed=2)).reshape(-1, 16)
        model.codebook.copy_(z[torch.randperm(z.shape[0],
                                              generator=torch.Generator()
                                              .manual_seed(1))[:32]])
    tok, eager = _served(model), Tokenizer(
        model=model, policy=Policy(torch.bfloat16, torch.bfloat16))
    x = _images(2, seed=3)
    for _ in range(3):
        ids = tok.encode_discrete(x)
        assert ids.dtype == torch.int64 and torch.equal(
            ids, eager.encode_discrete(x))
        assert torch.equal(tok.encode_discrete(tok.encode(x)), ids)
        assert torch.equal(tok.decode_discrete(ids),
                           eager.decode_discrete(ids))
    # encode_discrete of images, of latents, encode, decode_discrete
    assert fake_graphs.captures == 4


def test_encode_driver_says_which_mode(tmp_path, monkeypatch, capsys):
    """cli.encode builds its Tokenizer with the default and prints the mode
    beside the decoder: off on the CPU."""
    import json

    from tae_tpu_torch.cli import encode
    from tae_tpu_torch.data.fake import make_fake_wds_shard

    monkeypatch.setenv("TAE_TPU_NATIVE", "0")
    make_fake_wds_shard(tmp_path / "d-000000.tar", num_samples=4, size=72)
    encode.main(encode.get_args_parser().parse_args([
        "--model", NAME, "--model_args", json.dumps(TINY), "--input_size",
        "64", "--num_workers", "0", "--batch_size", "2", "--num_iters", "2",
        "--deterministic", "--device", "cpu", "--data_path",
        str(tmp_path / "d-000000.tar"), "--output_dir", str(tmp_path / "out"),
        "--save_prefix", "enc"]))
    out = capsys.readouterr().out
    assert "decoder: pil" in out and "cuda graphs: off" in out


def test_smoke_run_knows_the_library_kernels():
    """chip_smoke.py holds a replay's kernels against an eager request's
    by the names of the port's ``__global__`` functions, read from the CUDA
    sources: every one is found (one with a nested ``__launch_bounds__``
    among them) in the names the profiler gives, and PyTorch's own kernels
    and copies are not."""
    import re

    import chip_smoke
    from tae_tpu_torch.ops.cuda import build

    pattern = chip_smoke.library_kernels()
    text = "".join(p.read_text() for p in build.sources())
    names = chip_smoke.kernel_names()
    assert len(set(names)) == len(re.findall(r"__global__", text))
    assert "layer_norm_fwd_rows_kernel" in names
    for name in ("void int8_matmul_kernel<2, false>(tae::Params)",
                 "void tae::rownorm::(anonymous namespace)::"
                 "layer_norm_fwd_rows_kernel<__nv_bfloat16, float, 4>"
                 "(__nv_bfloat16 const*)",
                 "nearest_code_wgmma_kernel(CUtensorMap, int)"):
        assert pattern.search(name), name
    for name in ("void at::native::vectorized_elementwise_kernel<4>(int)",
                 "Memcpy DtoD (Device -> Device)",
                 "void my_int8_matmul_kernel_copy<1>(int)"):
        assert not pattern.search(name), name
