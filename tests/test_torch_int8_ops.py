"""Port int8 (w8a8) ops vs the JAX package: weight and row quantization, and
the plain versions of the three int8 kernels (``ln_quant``,
``int8_matmul_fused``, ``int8_mlp``) against the Pallas kernels.

Inputs are made with numpy from a seed and fed to both packages. The Pallas
kernels run in interpret mode, as tests/test_ops.py runs them; the port runs
its plain versions (the kernel wrappers take them for CPU tensors). The JAX
package stores weights (in, out), the port torch-style (out, in).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.int8 import int8_linear as j_int8_linear
from tae_tpu.ops.int8 import quantize_weight as j_quantize_weight
from tae_tpu.ops.pallas.int8_block import int8_mlp as j_int8_mlp
from tae_tpu.ops.pallas.int8_block import ln_quant as j_ln_quant
from tae_tpu.ops.pallas.int8_matmul import int8_matmul_fused as j_matmul
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.cuda import int8_block, int8_matmul
from tae_tpu_torch.ops.cuda.int8_block import (
    int8_mlp, int8_mlp_reference, ln_quant, ln_quant_reference)
from tae_tpu_torch.ops.cuda.int8_matmul import (
    int8_matmul_fused, int8_matmul_reference, ln_chain_rows)

# int8 codes of the two packages: both round the same fp32 value, which can
# differ in its last bits (summation order of the LayerNorm statistics, the
# two tanh and rsqrt implementations), so a value within that of a rounding
# tie lands on the neighbouring code. Codes may differ by 1 on at most this
# share of elements (measured here: no code differs in any case).
CODE_FLIP_SHARE = 1e-3
# per-row scales are max-reductions of such fp32 values (measured: up to
# 3.6e-7 relative, three fp32 ulps)
SCALE_RTOL = 1e-6


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _codes_close(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((diff > 0).mean())
    assert diff.max() <= 1 and share <= CODE_FLIP_SHARE, (diff.max(), share)


def _scales_close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=SCALE_RTOL, atol=0)


def _weights(rng, k, n, scale=1.0):
    """A float (k, n) weight quantized by the JAX package: (w_q (k, n),
    scales (n,)) as numpy."""
    wq, sw = j_quantize_weight(jnp.asarray(
        rng.standard_normal((k, n)).astype(np.float32) * scale))
    return np.asarray(wq), np.asarray(sw)


# ------------------------------------------------------------ quantization

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(64, 48), (256, 128), (33, 7)])
def test_quantize_weight_exact(k, n, dtype):
    w = np.random.default_rng(0).standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0                                   # a dead channel: scale floor
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = _t(w).to(getattr(torch, dtype))
    wq_j, s_j = j_quantize_weight(jw)               # (in, out)
    wq, s = int8.quantize_weight(tw.t().contiguous())   # (out, in)
    assert wq.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(wq.shape) == (n, k) and tuple(s.shape) == (n,)
    assert np.array_equal(wq.numpy().T, np.asarray(wq_j))
    assert np.array_equal(s.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_exact(dtype):
    """The float-input path: the JAX wrapper quantizes rows ahead of its
    kernel; with an identity weight of scale 1 the kernel's fp32 output is
    the codes times the row scale."""
    m, k = 32, 128
    x = np.random.default_rng(1).standard_normal((m, k)).astype(np.float32) * 3
    tx = _t(x).to(getattr(torch, dtype))
    xq, sx = int8.quantize_rows(tx)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    eye = jnp.eye(k, dtype=jnp.int8)
    y = j_matmul(jnp.asarray(x, getattr(jnp, dtype)), eye,
                 jnp.ones((k,), jnp.float32), block_m=32, block_n=128,
                 block_k=128, out_dtype=jnp.float32, interpret=True)
    np.testing.assert_array_equal(xq.float().numpy() * sx.numpy(),
                                  np.asarray(y))


# ------------------------------------------------------------- K3 ln_quant

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(64, 128), (37, 256), (130, 384)])
def test_ln_quant_matches_pallas(m, d, dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, d)).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(d).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xq_j, sx_j = j_ln_quant(jnp.asarray(x, jd), jnp.asarray(w, jd),
                            jnp.asarray(b, jd), 1e-6, interpret=True)
    args = (_t(x).to(td), _t(w).to(td), _t(b).to(td), 1e-6)
    xq, sx = ln_quant_reference(*args)
    assert tuple(xq.shape) == (m, d) and tuple(sx.shape) == (m, 1)
    _scales_close(sx, sx_j)
    _codes_close(xq, xq_j)
    # the wrapper and the dispatcher take the plain version on the CPU
    for fn in (ln_quant, int8.ln_quant):
        xq2, sx2 = fn(*args)
        assert torch.equal(xq2, xq) and torch.equal(sx2, sx)


# ----------------------------------------------------- K4 int8_matmul_fused

def _matmul_inputs(m, k, n, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq, sx = j_ln_quant(jnp.asarray(x), jnp.ones((k,)), jnp.zeros((k,)), 1e-6,
                        interpret=True)
    wq, sw = _weights(rng, k, n)
    b = rng.standard_normal(n).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    return np.asarray(xq), np.asarray(sx), wq, sw, b, res


@pytest.mark.parametrize("bias,residual", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_int8_matmul_matches_pallas(bias, residual):
    """Identical int8 inputs give the identical int32 product, so the fp32
    outputs differ only by how the epilogue's products and sums round."""
    m, k, n = 64, 256, 128
    xq, sx, wq, sw, b, res = _matmul_inputs(m, k, n)
    want = j_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sw),
                    jnp.asarray(b) if bias else None, block_m=32,
                    block_n=128, block_k=128, out_dtype=jnp.float32,
                    x_scale=jnp.asarray(sx),
                    residual=jnp.asarray(res) if residual else None,
                    interpret=True)
    args = (_t(xq), _t(sx), _t(wq.T), _t(sw), _t(b) if bias else None,
            _t(res) if residual else None, torch.float32)
    got = int8_matmul_reference(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(int8_matmul_fused(*args), got)


@pytest.mark.parametrize("m", [64, 45])
def test_int8_linear_ln_out_matches_pallas(m):
    """The chained epilogue through both dispatchers (the JAX one pads the
    odd row count to its blocks)."""
    k, n = 256, 128
    xq, sx, wq, sw, b, res = _matmul_inputs(m, k, n, seed=4)
    rng = np.random.default_rng(5)
    g = rng.standard_normal(n).astype(np.float32) * 0.5 + 1
    be = rng.standard_normal(n).astype(np.float32) * 0.2
    y_j, nq_j, ns_j = j_int8_linear(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(b),
        x_scale=jnp.asarray(sx), residual=jnp.asarray(res),
        out_dtype=jnp.float32, interpret=True,
        ln_out=(jnp.asarray(g), jnp.asarray(be), 1e-6))
    assert nq_j is not None
    y, nq, ns = int8.int8_linear(
        _t(xq), _t(wq.T), _t(sw), _t(b), x_scale=_t(sx), residual=_t(res),
        out_dtype=torch.float32, ln_out=(_t(g), _t(be), 1e-6))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-6,
                               atol=1e-6)
    assert tuple(ns.shape) == (m, 1)
    _scales_close(ns, ns_j)
    _codes_close(nq, nq_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_float_input_matches_pallas(dtype):
    """A float x goes through quantize_rows on both sides; 3-d input."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    wq, sw = _weights(rng, 256, 128, 0.1)
    b = rng.standard_normal(128).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_int8_linear(jnp.asarray(x, jd), jnp.asarray(wq), jnp.asarray(sw),
                         jnp.asarray(b, jd), interpret=True)
    got = int8.int8_linear(_t(x).to(td), _t(wq.T), _t(sw), _t(b).to(td))
    assert got.dtype == td and tuple(got.shape) == (2, 24, 128)
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-6))     # one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_ln_chain_rule_and_q8_out():
    """The chained epilogue is switched by the documented rule on N alone;
    past it the dispatcher returns (y, None, None), as the JAX one does
    when its plan is infeasible."""
    widths = (128, 1024, 1272, 1280, 2048, 2560, 3088, 3096, 1001)
    assert [ln_chain_rows(n) for n in widths] == [32, 32, 32, 16, 16, 16, 16,
                                                  None, None]
    n, k, m = 3096, 32, 4
    rng = np.random.default_rng(7)
    xq = _t(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = _t(rng.integers(-127, 128, (n, k), dtype=np.int8))
    sx, sw = torch.full((m, 1), 0.01), torch.full((n,), 0.001)
    ln = (torch.ones(n), torch.zeros(n), 1e-6)
    y, yq, ys = int8.int8_linear(xq, wq, sw, x_scale=sx, ln_out=ln)
    assert yq is None and ys is None
    assert torch.equal(y, int8.int8_linear(xq, wq, sw, x_scale=sx))
    # q8_out: int8 y with one scale per row and block of q8_block(N) columns
    # (N = 3096 has no multiple of 128 dividing it: one block of the row)
    yq, ys = int8.int8_linear(xq, wq, sw, x_scale=sx, q8_out=True)
    assert yq.dtype == torch.int8 and tuple(ys.shape) == (1, m, 1)
    # dequantized: half a code step from the fp32 y, y itself in bf16
    assert float((yq.float() * ys[0] - y.float()).abs().max()) \
        <= 0.5 * float(ys.max()) + 2.0 ** -8 * float(y.float().abs().max())
    with pytest.raises(ValueError, match="exclude"):
        int8.int8_linear(xq, wq, sw, x_scale=sx, q8_out=True, ln_out=ln)
    with pytest.raises(TypeError, match="x_scale"):
        int8.int8_linear(xq, wq, sw)


# ------------------------------------------------------------ K5 int8_mlp

# The JAX test's own bound against its emulation is atol = rtol = 1e-3
# (tests/test_ops.py); the two sides here agree far closer. They take tanh
# from different libraries, so a hidden value within an ulp of a rounding
# tie could flip its int8 code and move that output row by one hidden
# quantization step (about 1e-4 of the output's range); none does here.
# Measured max |diff|: 1.9e-6 on outputs up to 14.
MLP_TOL = dict(atol=1e-5, rtol=1e-5)


def _mlp_inputs(m, d, hdim):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, d)).astype(np.float32)
    xq, sx = j_ln_quant(jnp.asarray(x), jnp.ones((d,)), jnp.zeros((d,)), 1e-6,
                        interpret=True)
    w1q, s1 = _weights(rng, d, hdim, 0.1)
    w2q, s2 = _weights(rng, hdim, d, 0.1)
    b1 = rng.standard_normal(hdim).astype(np.float32) * 0.1
    b2 = rng.standard_normal(d).astype(np.float32) * 0.1
    res = rng.standard_normal((m, d)).astype(np.float32)
    g = rng.standard_normal(d).astype(np.float32) * 0.5 + 1
    be = rng.standard_normal(d).astype(np.float32) * 0.2
    return np.asarray(xq), np.asarray(sx), w1q, s1, b1, w2q, s2, b2, res, g, be


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("m,d,hdim,bh", [(64, 128, 512, 512),
                                         (64, 128, 512, 128),
                                         (40, 256, 1024, 256)])
def test_int8_mlp_matches_pallas(m, d, hdim, bh, chain):
    xq, sx, w1q, s1, b1, w2q, s2, b2, res, g, be = _mlp_inputs(m, d, hdim)
    j = jnp.asarray
    want = j_int8_mlp(j(xq), j(sx), j(w1q), j(s1), j(b1), j(w2q), j(s2),
                      j(b2), j(res), block_m=32, block_h=bh,
                      out_dtype=jnp.float32, interpret=True,
                      ln_next=(j(g), j(be), 1e-6) if chain else None)
    args = (_t(xq), _t(sx), _t(w1q.T), _t(s1), _t(b1), _t(w2q.T), _t(s2),
            _t(b2), _t(res), bh, torch.float32,
            (_t(g), _t(be), 1e-6) if chain else None)
    got = int8_mlp_reference(*args)
    again = int8_mlp(*args)                 # the wrapper, on the CPU
    if not chain:
        assert torch.equal(again, got)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLP_TOL)
        return
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert want[1] is not None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **MLP_TOL)
    _scales_close(got[2], want[2])
    _codes_close(got[1], want[1])


def test_int8_mlp_block_h_is_part_of_the_numerics():
    xq, sx, w1q, s1, b1, w2q, s2, b2, res, _, _ = _mlp_inputs(64, 128, 512)
    args = (_t(xq), _t(sx), _t(w1q.T), _t(s1), _t(b1), _t(w2q.T), _t(s2),
            _t(b2), _t(res))
    a = int8_mlp_reference(*args, block_h=128, out_dtype=torch.float32)
    b = int8_mlp_reference(*args, block_h=512, out_dtype=torch.float32)
    assert not torch.equal(a, b)
    # both are the same MLP, to int8 accuracy
    assert float((a - b).abs().mean() / b.abs().mean()) < 0.02
    with pytest.raises(ValueError, match="block_h"):
        int8_mlp_reference(*args, block_h=384)
    assert int8_block.DEFAULT_BLOCK_H == int8.DEFAULT_BLOCK_H == 256
    # the kernel's tiles (fc1, fc2, hidden groups) follow from the shapes
    # and the SM count alone: p16, p32 and p128 at B = 64 on 132 SMs
    assert int8_block.mlp_tiles(16384, 1024, 4096, 256, 132) == (2, 0, 1)
    assert int8_block.mlp_tiles(4096, 2048, 8192, 256, 132) == (2, 0, 1)
    assert int8_block.mlp_tiles(256, 2560, 10240, 256, 132) == (2, 1, 1)
    with pytest.raises(ValueError, match="block_h"):
        int8_block.mlp_tiles(64, 1024, 4096, 192, 132)
    with pytest.raises(ValueError, match="shared memory"):
        int8_block.mlp_tiles(64, 2560, 10240, 2048, 132)


@pytest.mark.parametrize("row_blocks,hidden_blocks,sms,want", [
    (8, 16, 132, 16),      # M = 256: one hidden block per kernel block
    (64, 16, 132, 2),      # M = 2048
    (32, 16, 132, 4),
    (66, 16, 132, 2),
    (67, 16, 132, 1),      # from half the SMs on: one kernel, no split
    (512, 16, 132, 1),     # M = 16384
    (1, 40, 132, 40),
    (10, 40, 132, 10),     # only divisors of the hidden block count
    (3, 1, 132, 1),
])
def test_int8_mlp_hidden_groups_rule(row_blocks, hidden_blocks, sms, want):
    """Few rows leave SMs idle, so the kernel deals its hidden blocks to
    groups; the rule is a function of the shapes and the SM count alone."""
    got = int8_block.mlp_hidden_groups(row_blocks, hidden_blocks, sms)
    assert got == want
    assert hidden_blocks % got == 0


def test_int8_wrappers_refuse_non_cpu_tensors_without_fallback():
    meta = dict(device="meta")
    xq = torch.empty((4, 32), dtype=torch.int8, **meta)
    wq = torch.empty((16, 32), dtype=torch.int8, **meta)
    sx, sw = torch.empty((4, 1), **meta), torch.empty(16, **meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_matmul_fused(xq, sx, wq, sw)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ln_quant(torch.empty((4, 32), **meta), torch.empty(32, **meta),
                 torch.empty(32, **meta))
    w2 = torch.empty((32, 16), dtype=torch.int8, **meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_mlp(xq, sx, wq, sw, sw, w2, torch.empty(32, **meta),
                 torch.empty(32, **meta), torch.empty((4, 32), **meta))
    with pytest.raises(TypeError, match="int8"):
        int8_matmul_fused(torch.zeros(4, 32), torch.ones(4, 1),
                          torch.zeros((16, 32), dtype=torch.int8),
                          torch.ones(16))
    assert int8_matmul.SMEM_LIMIT == 232448
