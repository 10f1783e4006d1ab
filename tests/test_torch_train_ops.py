"""The port's training ops vs the JAX package: LayerNorm and packed-qkv
attention with their gradients, the wide entry's gradient, and the rule that
a kernel wrapper either carries a gradient or refuses one.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side is ``jax.vjp`` of the Pallas entries in interpret mode (their backward
kernels too, as tests/test_ops.py runs them); the port runs its
``autograd.Function``s, whose two directions are the kernels' plain versions
on CPU tensors: the explicit backward formulas, not autograd of the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.pallas.flash_attention import _packed_fwd_call
from tae_tpu.ops.pallas.flash_attention import fused_qkv_attention as j_fqa
from tae_tpu.ops.pallas.flash_attention import (
    fused_qkv_attention_wide as j_wide)
from tae_tpu.ops.pallas.layernorm import _fwd_call as j_ln_fwd_call
from tae_tpu.ops.pallas.layernorm import fused_layer_norm as j_fln
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.attention import packed_attention
from tae_tpu_torch.ops.cuda import flash_attention as fa
from tae_tpu_torch.ops.cuda import int8_block, int8_matmul
from tae_tpu_torch.ops.cuda import layernorm as ln
from tae_tpu_torch.ops.cuda import wide_attention as wa
from tae_tpu_torch.ops.layernorm import (layer_norm,
                                         layer_norm_backward_reference,
                                         layer_norm_reference,
                                         layer_norm_stats_reference)

# fp32 on both sides, sums taken in another order (the bound the forward
# tests use, tests/test_torch_ops.py); gradients sum a few hundred terms of
# size ~1, so their absolute bound is a little wider
FP32 = dict(atol=2e-5, rtol=2e-5)
FP32_GRAD = dict(atol=1e-4, rtol=1e-4)
# one bf16 ulp is 2^-8 to 2^-7 of the value: both sides compute in fp32 and
# round once, and a last-bit difference can flip that rounding
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a)).to(dtype).requires_grad_(grad)


# --------------------------------------------------------------- layernorm

def _ln_inputs(shape, seed=9):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = (rng.standard_normal(d) + 1).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, dy


@pytest.mark.parametrize("shape", [(4, 7, 256), (100, 64), (3, 1024)])
def test_layer_norm_gradients_fp32_match_jax(shape):
    x, w, b, dy = _ln_inputs(shape)
    y_j, vjp = jax.vjp(lambda *a: j_fln(*a, 1e-6, True),
                       *map(jnp.asarray, (x, w, b)))
    want = vjp(jnp.asarray(dy))
    tx, tw, tb = (_t(a, grad=True) for a in (x, w, b))
    y = ln.fused_layer_norm(tx, tw, tb, 1e-6)
    assert type(y.grad_fn).__name__ == "FusedLayerNormFnBackward"
    got = torch.autograd.grad(y, (tx, tw, tb), _t(dy))
    _close(y, y_j, **FP32)
    for g, wnt in zip(got, want):
        # dw and db sum over up to 100 rows of |dy * xhat| ~ 1
        _close(g, wnt, **FP32_GRAD)


def test_layer_norm_gradients_bf16_match_jax():
    """bf16 in, fp32 inside, as the model calls it: the weight cast to the
    activations' dtype, so dw and db come back in bf16 on both sides."""
    x, w, b, dy = _ln_inputs((64, 512), seed=3)
    bf = jnp.bfloat16
    y_j, vjp = jax.vjp(lambda *a: j_fln(*a, 1e-6, True),
                       *(jnp.asarray(a, bf) for a in (x, w, b)))
    want = vjp(jnp.asarray(dy, bf))
    tx, tw, tb = (_t(a, torch.bfloat16, True) for a in (x, w, b))
    y = ln.fused_layer_norm(tx, tw, tb, 1e-6)
    got = torch.autograd.grad(y, (tx, tw, tb), _t(dy, torch.bfloat16))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert [g.dtype for g in want] == [bf] * 3
    _close(y, y_j, **BF16_ULP)
    for g, wnt in zip(got, want):
        _close(g, wnt, atol=1e-3, rtol=2.0 ** -7)   # fp32 sums, one rounding


def test_layer_norm_stats_match_jax_forward():
    x, w, b, _ = _ln_inputs((37, 128), seed=5)
    y_j, mean_j, rstd_j = j_ln_fwd_call(*map(jnp.asarray, (x, w, b)), 1e-6,
                                        True, True)
    y, mean, rstd = ln.fused_layer_norm_fwd_stats(*map(_t, (x, w, b)), 1e-6)
    assert mean.shape == rstd.shape == (37,) and mean.dtype == torch.float32
    _close(y, y_j, **FP32)
    _close(mean, mean_j[:, 0], **FP32)
    _close(rstd, rstd_j[:, 0], atol=1e-6, rtol=1e-5)
    same = layer_norm_stats_reference(*map(_t, (x, w, b)), 1e-6)
    assert all(torch.equal(a, c) for a, c in zip((y, mean, rstd), same))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_formula_matches_autograd(dtype):
    """The explicit backward against torch autograd of the plain forward,
    with dy in a non-contiguous layout."""
    x, w, b, dy = _ln_inputs((6, 10, 64), seed=2)
    tx, tw, tb = (_t(a, dtype, True) for a in (x, w, b))
    tdy = _t(dy.transpose(1, 0, 2).copy(), dtype).transpose(0, 1)
    assert not tdy.is_contiguous()
    want = torch.autograd.grad(layer_norm_reference(tx, tw, tb), (tx, tw, tb),
                               tdy)
    _, mean, rstd = layer_norm_stats_reference(tx, tw, tb)
    got = layer_norm_backward_reference(tx.detach(), tw.detach(), mean, rstd,
                                        tdy)
    via_fn = torch.autograd.grad(ln.fused_layer_norm(tx, tw, tb),
                                 (tx, tw, tb), tdy)
    tol = FP32_GRAD if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for g, f, wnt in zip(got, via_fn, want):
        assert g.dtype == dtype and torch.equal(g, f)
        _close(g, wnt, **tol)


# --------------------------------------------------------------- attention

def _qkv(b, n, h, dh, seed=5):
    rng = np.random.default_rng(seed)
    c = h * dh
    return (rng.standard_normal((b, n, 3 * c)).astype(np.float32),
            rng.standard_normal((b, n, c)).astype(np.float32))


GRAD_SHAPES = [(16, 2, 64), (64, 2, 64), (21, 3, 80), (4, 2, 64)]


@pytest.mark.parametrize("n,h,dh", GRAD_SHAPES)
def test_packed_attention_gradient_fp32_matches_jax(n, h, dh):
    qkv, do = _qkv(2, n, h, dh)
    y_j, vjp = jax.vjp(lambda q: j_fqa(q, h, None, True, False),
                       jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(do))
    tq = _t(qkv, grad=True)
    y = fa.fused_qkv_attention(tq, h, serving=False)
    assert type(y.grad_fn).__name__ == "FusedQKVAttentionFnBackward"
    (got,) = torch.autograd.grad(y, tq, _t(do))
    _close(y, y_j, **FP32)
    _close(got, want, **FP32_GRAD)


@pytest.mark.parametrize("n,h,dh", GRAD_SHAPES[:3])
def test_packed_attention_gradient_bf16_matches_jax(n, h, dh):
    qkv, do = _qkv(2, n, h, dh, seed=6)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda q: j_fqa(q, h, None, True, False),
                     jnp.asarray(qkv, bf))
    (want,) = vjp(jnp.asarray(do, bf))
    tq = _t(qkv, torch.bfloat16, True)
    (got,) = torch.autograd.grad(fa.fused_qkv_attention(tq, h, serving=False),
                                 tq, _t(do, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # The JAX body upcasts every operand to fp32 and rounds the result once.
    # The port, like its tensor-core kernel, also rounds P and dS to bf16
    # ahead of the last three products: each term is off by up to 2^-9 of
    # itself, the sums by less, and then comes the common final rounding
    # (2^-8). Outputs are O(1) sums of terms of both signs, hence the atol.
    _close(got, want, atol=1.5e-2, rtol=1.5e-2)


@pytest.mark.parametrize("n,h,dh", [(16, 2, 64), (37, 2, 80)])
def test_packed_attention_lse_matches_jax(n, h, dh):
    qkv, _ = _qkv(2, n, h, dh, seed=7)
    o_j, lse_j = _packed_fwd_call(jnp.asarray(qkv), h, dh ** -0.5, True, True)
    o, lse = fa.fused_qkv_attention_fwd_lse(_t(qkv), h)
    assert lse.shape == (2, h, n) and lse.dtype == torch.float32
    _close(o, o_j, **FP32)
    _close(lse, lse_j[..., 0], **FP32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_backward_formula_matches_autograd(dtype):
    """The explicit backward against torch autograd of the plain forward
    (which rounds p once and nothing else), do in a non-contiguous layout."""
    qkv, do = _qkv(2, 24, 2, 64, seed=8)
    tq = _t(qkv, dtype, True)
    tdo = _t(do.transpose(1, 0, 2).copy(), dtype).transpose(0, 1)
    (want,) = torch.autograd.grad(
        fa.fused_qkv_attention_reference(tq, 2, serving=False), tq, tdo)
    o, lse = fa.fused_qkv_attention_lse_reference(tq.detach(), 2)
    got = fa.fused_qkv_attention_backward_reference(tq.detach(), o, lse, tdo, 2)
    tol = FP32_GRAD if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    _close(got, want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,dh", [(4, 2, 64), (8, 3, 80)])
def test_wide_attention_gradient_matches_jax(n, h, dh, dtype):
    """The tiny-N entry: forward the (plain version of the) kernel, backward
    autograd of the plain attention reference, on both sides."""
    qkv, do = _qkv(3, n, h, dh, seed=9)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_j, vjp = jax.vjp(lambda q: j_wide(q, h, None, None, True, False),
                       jnp.asarray(qkv, jd))
    (want,) = vjp(jnp.asarray(do, jd))
    tq = _t(qkv, td, True)
    y = wa.fused_qkv_attention_wide(tq, h, serving=False)
    assert type(y.grad_fn).__name__ == "WideAttentionFnBackward"
    (got,) = torch.autograd.grad(y, tq, _t(do, td))
    if dtype == "float32":
        _close(y, y_j, **FP32)
        _close(got, want, **FP32_GRAD)
    else:
        # both differentiate softmax -> cast to bf16 -> P.V; XLA and torch
        # round the intermediate gradients at other points (2^-8 each)
        _close(got, want, atol=2e-2, rtol=2e-2)


# ---------------------------------- a wrapper carries a gradient or refuses

def _int8_operands(m=8, k=64, n=64):
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    sx = torch.rand(m, 1) * 0.05 + 0.01
    sw = torch.rand(n) * 4e-4 + 1e-4
    return xq, sx, wq, sw


def _forward_only_calls():
    """name -> a call of each forward-only entry on a tensor that requires a
    gradient."""
    qkv = torch.randn(2, 4, 3 * 128, requires_grad=True)
    x = torch.randn(8, 64, requires_grad=True)
    g, b = torch.ones(64), torch.zeros(64)
    xq, sx, wq, sw = _int8_operands()
    bias = torch.zeros(64, requires_grad=True)
    res = torch.randn(8, 64, requires_grad=True)
    w1, s1 = _int8_operands(8, 64, 256)[2:]
    w2, s2 = _int8_operands(8, 256, 64)[2:]
    return {
        "K2 serving": lambda: fa.fused_qkv_attention(qkv, 2, serving=True),
        "K6 serving": lambda: wa.fused_qkv_attention_wide(qkv, 2, serving=True),
        "K7": lambda: wa.fused_qkv_attention_q8(qkv, 2),
        "K8": lambda: wa.fused_qkv_attention_wide_q8(qkv, 2),
        "K9": lambda: wa.fused_qkv_attention_wide_q8_2d(
            qkv.reshape(8, -1), 4, 2),
        "K3": lambda: int8_block.ln_quant(x, g, b),
        "K3 dispatch": lambda: int8.ln_quant(x, g, b),
        "K4 bias": lambda: int8_matmul.int8_matmul_fused(
            xq, sx, wq, sw, bias, None, torch.float32),
        "K4 residual": lambda: int8_matmul.int8_matmul_fused(
            xq, sx, wq, sw, None, res, torch.float32),
        "int8_linear": lambda: int8.int8_linear(x, wq, sw, bias),
        "q8 route": lambda: packed_attention(qkv, 2, "wide_q8", serving=True),
        "K5": lambda: int8_block.int8_mlp(
            xq, sx, w1, s1, torch.zeros(256), w2, s2, torch.zeros(64), res,
            256, torch.float32),
    }


@pytest.mark.parametrize("entry", ["K2 serving", "K6 serving", "K7", "K8", "K9",
                                   "K3", "K3 dispatch", "K4 bias",
                                   "K4 residual", "K5", "int8_linear",
                                   "q8 route"])
def test_forward_only_entries_refuse_a_gradient(entry):
    """The check sits ahead of the device dispatch, so it runs on the CPU:
    RuntimeError naming the entry; under no_grad the same call goes through
    and returns tensors without a grad_fn."""
    call = _forward_only_calls()[entry]
    with pytest.raises(RuntimeError, match="forward-only"):
        call()
    with torch.no_grad():
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is None for o in outs)


def test_gradients_flow_through_every_differentiable_entry():
    """Every parameter ahead of a kernel entry gets a gradient, on the plain
    path (backend="reference", autograd) and through the Functions
    (backend="kernel"), and both agree."""
    torch.manual_seed(0)
    x = torch.randn(2, 16, 128)
    w_in = torch.randn(128, 128, requires_grad=True)
    gamma = torch.ones(128, requires_grad=True)
    beta = torch.zeros(128, requires_grad=True)
    w_qkv = (torch.randn(384, 128) * 0.1).requires_grad_()
    grads = {}
    for backend in ("reference", "kernel"):
        for route, tokens in (("packed", 16), ("wide", 8)):
            h = layer_norm(x[:, :tokens] @ w_in, gamma, beta, backend=backend)
            y = packed_attention(h @ w_qkv.T, 2, route, serving=False,
                                 backend=backend)
            assert y.grad_fn is not None
            grads[backend, route] = torch.autograd.grad(
                y.square().sum(), (w_in, gamma, beta, w_qkv))
    for route in ("packed", "wide"):
        for a, b in zip(grads["kernel", route], grads["reference", route]):
            assert float(a.abs().max()) > 0
            _close(a, b, atol=1e-3, rtol=1e-4)
    # without a gradient the forward-only entries run: no Function, no count
    with torch.no_grad():
        y = packed_attention(torch.randn(2, 16, 384), 2, "packed",
                             serving=True, backend="kernel")
    assert y.grad_fn is None
    counters = (ln.fused_layer_norm, ln.fused_layer_norm_fwd_stats,
                ln.fused_layer_norm_bwd, fa.fused_qkv_attention,
                fa.fused_qkv_attention_fwd_lse, fa.fused_qkv_attention_bwd,
                wa.fused_qkv_attention_wide)
    assert all(f.launches == 0 for f in counters)


def test_backward_row_chunks_cover_every_row():
    for rows in (1, 127, 128, 129, 16384, 131072, 131073, 2 ** 31 - 1):
        chunks, per = ln.bwd_row_chunks(rows)
        assert chunks * per >= rows > (chunks - 1) * per
        assert chunks <= ln.BWD_MAX_CHUNKS
        # 128 rows a chunk or more, or few rows spread over at most 128
        # chunks of a multiple of 8 rows
        assert per >= ln.BWD_ROWS_PER_CHUNK or (chunks <= ln.FILL_BLOCKS
                                                and per % ln.BWD_WARPS == 0)
