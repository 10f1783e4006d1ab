"""The port's int4 (w4a8) ops vs the JAX package, on the CPU: weight
quantization (codes and scales exact), the packed byte layout and its bridge,
the group rule, the w4a8 matmul and the fused int4 MLP.

The JAX side runs its Pallas kernels in interpret mode (and its XLA
fallback); the port runs its plain versions, the ones the CUDA kernels are
held against on the card. Inputs come from numpy seeds. The two packages
pack the same codes into different bytes (the port's layout serves the
H100's tensor-core operand order) and add the same exact group terms in
another order, so products agree to fp32 rounding, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops import int4 as jint4
from tae_tpu.ops.int8 import _block as j_block
from tae_tpu.ops.pallas.int4_block import int4_mlp as j_int4_mlp
from tae_tpu.ops.pallas.int4_matmul import int4_matmul_fused as j_int4_matmul
from tae_tpu.ops.pallas.int8_block import ln_quant as j_ln_quant
from tae_tpu_torch.ckpt.bridge import _repack_int4
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops import int4, int8
from tae_tpu_torch.ops.cuda.int4_block import int4_mlp, int4_mlp_reference
from tae_tpu_torch.ops.cuda.int4_matmul import (LAYOUT, int4_matmul_fused,
                                                int4_matmul_reference,
                                                pack_int4, unpack_int4)


def _j_codes(w4j) -> np.ndarray:
    """The JAX package's packed bytes -> its codes (K, N)."""
    lo, hi = jint4.unpack_int4(w4j)
    return np.concatenate([np.asarray(lo), np.asarray(hi)], axis=0)


def _weight(rng, k, n, scale=1.0):
    return (rng.standard_normal((k, n)) * scale).astype(np.float32)


# -------------------------------------------------------------- quantization

@pytest.mark.parametrize("half_k", [64, 128, 256, 384, 512, 640, 1280, 5120,
                                    192, 100])
def test_group_size_is_the_jax_rule(half_k):
    assert int4.group_size(half_k) == jint4.group_size(half_k)
    assert int4.group_size(half_k, 128) == j_block(half_k, 128)


@pytest.mark.parametrize("k,n,group", [(256, 128, None), (512, 384, None),
                                       (512, 128, 128), (2560, 64, None),
                                       (768, 40, None)])
def test_quantize_weight_int4_codes_and_scales_equal_jax(k, n, group):
    """Exact: the same fp32 arithmetic on both sides (run eagerly)."""
    w = _weight(np.random.default_rng(k + n), k, n)
    w4j, sj = jint4.quantize_weight_int4(jnp.asarray(w), group)
    w4, s = int4.quantize_weight_int4(torch.from_numpy(w.T.copy()), group)
    g = group or int4.group_size(k // 2)
    assert w4.dtype == torch.uint8 and tuple(w4.shape) == (n, k // 2)
    assert tuple(s.shape) == (k // g, n) and s.dtype == torch.float32
    assert np.array_equal(s.numpy(), np.asarray(sj))
    codes = unpack_int4(w4).numpy()
    assert np.array_equal(codes.T, _j_codes(w4j))
    assert codes.min() >= -7 and codes.max() <= 7


def test_quantize_weight_int4_on_a_depth_stacked_leaf_equals_jax():
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((3, 256, 96))).astype(np.float32)
    w4j, sj = jax.vmap(lambda x: jint4.quantize_weight_int4(x))(jnp.asarray(w))
    for i in range(3):
        w4, s = int4.quantize_weight_int4(torch.from_numpy(w[i].T.copy()))
        assert np.array_equal(s.numpy(), np.asarray(sj[i]))
        assert np.array_equal(unpack_int4(w4).numpy().T, _j_codes(w4j[i]))


def test_quantize_weight_int4_refuses_odd_shapes():
    with pytest.raises(ValueError, match="even"):
        int4.quantize_weight_int4(torch.zeros(4, 7))
    with pytest.raises(ValueError, match="must divide"):
        int4.quantize_weight_int4(torch.zeros(4, 256), group=96)


@pytest.mark.parametrize("k,expect", [(128, False), (256, True), (2560, True),
                                      (255, False), (384, False),
                                      (512, True)])
def test_int4_ok_is_the_jax_shape_rule(k, expect):
    assert int4.int4_ok(k) is expect
    assert jint4._int4_ok(jnp.zeros((k, 8))) is expect


# -------------------------------------------------------------- byte layout

def test_pack_unpack_round_trip_and_layout():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-7, 8, (5, 96)).astype(np.int8))
    w4 = pack_int4(q)
    assert w4.dtype == torch.uint8 and tuple(w4.shape) == (5, 48)
    assert torch.equal(unpack_int4(w4), q)
    assert torch.equal(pack_int4(unpack_int4(w4)), w4)
    # the documented layout: within a run of 32 inputs, byte j holds input j
    # (low nibble) and input 16 + j (high nibble), two's complement
    assert LAYOUT == int4.LAYOUT == "k32-twos"
    b = w4.numpy().astype(np.int32)
    for run in range(3):
        for j in range(16):
            lo, hi = int(q[2, 32 * run + j]), int(q[2, 32 * run + 16 + j])
            assert b[2, 16 * run + j] == (lo & 15) | ((hi & 15) << 4)
    # a depth-stacked leaf packs per layer
    q3 = torch.from_numpy(rng.integers(-7, 8, (2, 3, 64)).astype(np.int8))
    assert torch.equal(pack_int4(q3)[1], pack_int4(q3[1]))
    assert torch.equal(unpack_int4(pack_int4(q3)), q3)
    with pytest.raises(ValueError, match="multiple of 32"):
        pack_int4(torch.zeros((2, 48), dtype=torch.int8))
    with pytest.raises(ValueError, match="uint8"):
        unpack_int4(torch.zeros((2, 16), dtype=torch.int8))


def test_bridge_repacks_jax_bytes_into_the_ports_layout():
    """pack (JAX) -> bridge -> unpack (port): the same codes, and the same
    bytes as packing in the port."""
    w = _weight(np.random.default_rng(2), 512, 72)
    w4j, sj = jint4.quantize_weight_int4(jnp.asarray(w))
    w4, s = int4.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    bridged = _repack_int4(np.asarray(w4j))
    assert torch.equal(bridged, w4)
    assert np.array_equal(unpack_int4(bridged).numpy().T, _j_codes(w4j))
    # extreme nibbles survive: -7 and 7 in both planes
    q = np.array([[-7, 7], [7, -7]] * 16, np.int32).T            # (2, 32)
    lo, hi = q[:, :16].T, q[:, 16:].T                            # JAX: (K/2, N)
    jbytes = (hi * 16 + (lo + 8)).astype(np.int8)
    assert np.array_equal(unpack_int4(_repack_int4(jbytes)).numpy(), q)


def test_dequantize_int4_matches_jax():
    w = _weight(np.random.default_rng(3), 512, 40)
    w4j, sj = jint4.quantize_weight_int4(jnp.asarray(w))
    w4, s = int4.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    got = int4.dequantize_int4(w4, s)
    assert tuple(got.shape) == (40, 512)
    assert np.array_equal(got.numpy().T,
                          np.asarray(jint4.dequantize_int4(w4j, sj)))
    # within half a step of the float weight, group by group
    step = s.repeat_interleave(256, dim=0).t().numpy()
    assert (np.abs(got.numpy() - w.T) <= 0.5 * step + 1e-7).all()


# ------------------------------------------------------------------- matmul

def _rel_to_max(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("prequantized", [True, False])
@pytest.mark.parametrize("bias,residual", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("m,k,n", [(40, 512, 256), (8, 256, 384)])
def test_int4_matmul_reference_matches_jax_kernel_and_xla(m, k, n, bias,
                                                          residual,
                                                          prequantized):
    """fp32 outputs; the two packages add the same exact group terms in
    another order, so they agree to fp32 rounding of a sum of K/G terms:
    1e-5 of the largest output (measured 1e-7)."""
    rng = np.random.default_rng(m + k + n)
    w = _weight(rng, k, n, 0.1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    r = rng.standard_normal((m, n)).astype(np.float32) if residual else None
    w4j, sj = jint4.quantize_weight_int4(jnp.asarray(w))
    w4, s = int4.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    tb = None if b is None else torch.from_numpy(b)
    tr = None if r is None else torch.from_numpy(r)
    jb = None if b is None else jnp.asarray(b)
    jr = None if r is None else jnp.asarray(r)
    if prequantized:
        xq, sx = int8.quantize_rows(torch.from_numpy(x))
        got = int4.int4_linear(xq, w4, s, tb, x_scale=sx, residual=tr,
                               out_dtype=torch.float32)
        jx, jsx = jnp.asarray(xq.numpy()), jnp.asarray(sx.numpy())
    else:
        got = int4.int4_linear(torch.from_numpy(x), w4, s, tb, residual=tr)
        jx, jsx = jnp.asarray(x), None
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    want = j_int4_matmul(jx, w4j, sj, jb, block_m=8, block_n=128,
                         out_dtype=jnp.float32, x_scale=jsx, residual=jr,
                         interpret=True)
    assert _rel_to_max(got, want) <= 1e-5
    xla = jint4.int4_linear_xla(jx, w4j, sj, jb, x_scale=jsx)
    xla = np.asarray(xla, np.float32) + (0 if r is None else r)
    # the XLA fallback multiplies dequantized fp32 weights: another order of
    # roundings again (its own tests allow 2e-3); for an int8 x it returns
    # bfloat16, one rounding of 2^-9 relative
    assert _rel_to_max(got, xla) <= (1e-2 if prequantized else 1e-4)
    # the wrapper on a CPU tensor is the plain version
    if prequantized:
        direct = int4_matmul_fused(xq, sx, w4, s, tb, tr, torch.float32)
        assert torch.equal(direct, got)
        assert torch.equal(direct, int4_matmul_reference(xq, sx, w4, s, tb, tr,
                                                         torch.float32))


def test_int4_linear_leading_dims_dtypes_and_float_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    w = _weight(rng, 256, 128)
    w4, s = int4.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    y = int4.int4_linear(torch.from_numpy(x), w4, s)
    assert tuple(y.shape) == (3, 5, 128) and y.dtype == torch.float32
    ref = x @ w
    rel = np.abs(y.numpy() - ref).mean() / np.abs(ref).mean()
    assert rel < 0.2, rel                    # group-quantization error
    yb = int4.int4_linear(torch.from_numpy(x).bfloat16(), w4, s)
    assert yb.dtype == torch.bfloat16
    xq, sx = int8.quantize_rows(torch.from_numpy(x))
    assert int4.int4_linear(xq, w4, s, x_scale=sx).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="x_scale"):
        int4.int4_linear(xq, w4, s)
    with pytest.raises(TypeError, match="already-quantized"):
        int4.int4_linear(torch.from_numpy(x), w4, s, x_scale=sx)


# ---------------------------------------------------------------------- MLP

def _mlp_case(m, d, hdim, g1, g2, seed=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w1 = _weight(rng, d, hdim, 0.1)
    b1 = (rng.standard_normal(hdim) * 0.1).astype(np.float32)
    w2 = _weight(rng, hdim, d, 0.1)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    res = rng.standard_normal((m, d)).astype(np.float32)
    j = dict(w1=jint4.quantize_weight_int4(jnp.asarray(w1), g1),
             w2=jint4.quantize_weight_int4(jnp.asarray(w2), g2))
    t = dict(w1=int4.quantize_weight_int4(torch.from_numpy(w1.T.copy()), g1),
             w2=int4.quantize_weight_int4(torch.from_numpy(w2.T.copy()), g2))
    xq, sx = j_ln_quant(jnp.asarray(x), jnp.ones((d,)), jnp.zeros((d,)), 1e-6,
                        interpret=True)
    return x, b1, b2, res, j, t, xq, sx


@pytest.mark.parametrize("m,d,hdim,bh", [(40, 256, 1024, 256),
                                         (32, 512, 2048, 512)])
def test_int4_mlp_reference_matches_jax_kernel(m, d, hdim, bh):
    """The same ``block_h`` on both sides (it is part of the numerics). The
    hidden blocks are summed in another order (the JAX kernel walks plane
    pairs), and XLA fuses ``h * sx + b1`` into one rounding, so a hidden code
    on a rounding tie can flip: near-exact for the bulk, one hidden step for
    the rest (the bound tests/test_ops.py holds the JAX kernel to)."""
    x, b1, b2, res, j, t, xq, sx = _mlp_case(m, d, hdim, 128, 256)
    want = j_int4_mlp(xq, sx, *j["w1"], jnp.asarray(b1), *j["w2"],
                      jnp.asarray(b2), jnp.asarray(res), block_m=8,
                      block_h=bh, out_dtype=jnp.float32, interpret=True)
    txq, tsx = torch.tensor(np.asarray(xq)), torch.tensor(np.asarray(sx))
    got = int4_mlp_reference(txq, tsx, *t["w1"], torch.from_numpy(b1),
                             *t["w2"], torch.from_numpy(b2),
                             torch.from_numpy(res), bh, torch.float32)
    diff = np.abs(got.numpy() - np.asarray(want))
    tol = 3e-3 + 3e-3 * np.abs(np.asarray(want))
    assert (diff > tol).mean() < 0.01, (diff > tol).mean()
    assert diff.max() < 5e-2, diff.max()
    assert np.median(diff) < 1e-5
    # the wrapper and the dispatcher on a CPU tensor are the plain version
    fc1, fc2 = (vit.Q4Linear(d, hdim), vit.Q4Linear(hdim, d))
    for lin, (w4, s), b in ((fc1, t["w1"], b1), (fc2, t["w2"], b2)):
        lin.w4_scale = s            # group 128 here, not the layer's default
        lin.w4.copy_(w4)
        lin.bias.copy_(torch.from_numpy(b))
    via = int4.int4_mlp(txq, tsx, fc1, fc2, torch.from_numpy(res), bh,
                        torch.float32)
    assert torch.equal(via, got)
    assert torch.equal(int4_mlp(txq, tsx, *t["w1"], torch.from_numpy(b1),
                                *t["w2"], torch.from_numpy(b2),
                                torch.from_numpy(res), bh, torch.float32), got)


def test_int4_mlp_reference_hidden_groups_and_block_h():
    """``groups`` (the kernel's grid split for few rows) only reorders the
    fp32 sum over hidden blocks; another ``block_h`` is another
    quantization."""
    x, b1, b2, res, j, t, xq, sx = _mlp_case(16, 256, 1024, 128, 256, seed=4)
    args = (torch.tensor(np.asarray(xq)), torch.tensor(np.asarray(sx)),
            *t["w1"], torch.from_numpy(b1), *t["w2"], torch.from_numpy(b2),
            torch.from_numpy(res))
    one = int4_mlp_reference(*args, 256, torch.float32, 1)
    for groups in (2, 4):
        split = int4_mlp_reference(*args, 256, torch.float32, groups)
        torch.testing.assert_close(split, one, atol=1e-5, rtol=1e-5)
    other = int4_mlp_reference(*args, 512, torch.float32)
    assert float((other - one).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="split"):
        int4_mlp_reference(*args, 256, torch.float32, 3)
    with pytest.raises(ValueError, match="block_h"):
        int4_mlp_reference(*args, 384, torch.float32)
    with pytest.raises(ValueError, match="block_h"):
        int4_mlp_reference(*args, 128, torch.float32)    # fc2's group is 256
    assert int4_mlp_reference(*args, 256, torch.bfloat16).dtype == torch.bfloat16


# ------------------------------------------------- forward-only, CPU counters

def test_int4_entries_refuse_a_tensor_that_requires_a_gradient():
    rng = np.random.default_rng(6)
    w4, s = int4.quantize_weight_int4(torch.from_numpy(_weight(rng, 64, 256)))
    x = torch.randn(4, 256)
    xq, sx = int8.quantize_rows(x)
    bias = torch.zeros(64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        int4.int4_linear(x.clone().requires_grad_(), w4, s)
    with pytest.raises(RuntimeError, match="forward-only"):
        int4.int4_linear(xq, w4, s, bias, x_scale=sx)
    with pytest.raises(RuntimeError, match="forward-only"):
        int4_matmul_fused(xq, sx, w4, s, bias)
    lin = vit.Linear(256, 64)
    lin.init_weights_(torch.Generator().manual_seed(0))
    q = vit.Q4Linear.from_float(lin)
    q.bias.requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        q(x)
    fc1, fc2 = vit.Q4Linear(256, 1024), vit.Q4Linear(1024, 256)
    res = torch.zeros(4, 256, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        int4.int4_mlp(xq, sx, fc1, fc2, res)
    with pytest.raises(RuntimeError, match="forward-only"):
        int4_mlp(xq, sx, fc1.w4, fc1.w4_scale, fc1.bias, fc2.w4, fc2.w4_scale,
                 fc2.bias, res)
    # under no_grad they run
    with torch.no_grad():
        assert int4.int4_linear(xq, w4, s, bias, x_scale=sx).shape == (4, 64)


def test_q4linear_from_float_holds_the_quantized_weight():
    lin = vit.Linear(512, 96)
    lin.init_weights_(torch.Generator().manual_seed(1))
    q = vit.Q4Linear.from_float(lin)
    w4, s = int4.quantize_weight_int4(lin.weight)
    assert torch.equal(q.w4, w4) and torch.equal(q.w4_scale, s)
    assert torch.equal(q.bias, lin.bias) and not q.bias.requires_grad
    empty = vit.Q4Linear.from_float(lin, fill=False)
    assert empty.w4.shape == q.w4.shape and empty.w4_scale.shape == (2, 96)
    assert set(q.state_dict()) == {"w4", "w4_scale", "bias"}
    x = torch.randn(3, 512, generator=torch.Generator().manual_seed(2))
    rel = float((q(x) - lin(x)).norm() / lin(x).norm())
    assert rel < 0.2, rel


def test_cpu_int4_ops_leave_the_launch_counters_at_zero():
    rng = np.random.default_rng(8)
    w4, s = int4.quantize_weight_int4(torch.from_numpy(_weight(rng, 64, 256)))
    int4.int4_linear(torch.randn(4, 256), w4, s)
    assert int4_matmul_fused.launches == 0 and int4_mlp.launches == 0
