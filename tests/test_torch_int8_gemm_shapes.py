"""The int8 GEMM body's plain versions against the JAX package, at the shapes
where the port's tiles end: K4 (``int8_matmul_fused`` with bias, residual
and ``ln_out``; ``int8_matmul_rows`` with ``q8_out`` and a float x) and K5
(``int8_mlp`` and the plain versions of its three launches), at M = 1, 4
and 129 rows (one row; fewer than the 16-row tile; one past a 128-row
tile), N a multiple of 8 but of no tile width, K past a 128-byte ring step,
and K5 with one, two and three hidden blocks. Also the tiling rules the
wrappers pass to the kernels (``matmul_tiles``, ``split_ranges``,
``mlp_tiles``) at the paths' shapes.

Inputs are made with numpy from a seed and fed to both packages; the Pallas
kernels run in interpret mode with one block per dimension (any shape
tiles), as tests/test_torch_int8_ops.py runs them; the port's wrappers take
their plain versions on CPU tensors. The JAX package stores weights (in,
out), the port torch-style (out, in).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.int8 import quantize_weight as j_quantize_weight
from tae_tpu.ops.pallas.int8_block import int8_mlp as j_int8_mlp
from tae_tpu.ops.pallas.int8_block import ln_quant as j_ln_quant
from tae_tpu.ops.pallas.int8_matmul import int8_matmul_fused as j_matmul
from tae_tpu_torch.ops.cuda import int8_block, int8_matmul
from tae_tpu_torch.ops.cuda.int8_block import (
    int8_mlp, int8_mlp_reference, mlp_fc1_reference, mlp_fc2_reference,
    mlp_finish_reference, mlp_tiles)
from tae_tpu_torch.ops.cuda.int8_matmul import (
    int8_matmul_fused, int8_matmul_rows, int_matmul, matmul_tiles,
    split_partials, split_ranges)

# fp32 outputs: the same int32 sums and the same epilogue, every product and
# sum rounded alike on both sides (measured: equal or one fp32 ulp apart)
FP32 = dict(rtol=1e-6, atol=1e-6)
# int8 codes: the fp32 value being rounded can differ in its last bit (XLA
# contracts the interpret-mode epilogue's first add into an FMA; the two
# packages' tanh and rsqrt), so a value within that of a rounding tie lands
# on the neighbouring code: codes may differ by 1 on at most this share
CODE_FLIP_SHARE = 1e-3
# q8_out scales are max-reductions of such values: the largest |y| of a
# block may itself be one fp32 ulp apart (the FMA), and the scale one more
# (XLA's amax * fp32(1 / 127) against amax / 127, tests/test_torch_qkv_q8.py)
SCALE_MAXULP = 2
# LayerNorm scales also carry the statistics' summation order (XLA's
# reductions against torch's): a few fp32 ulps, as tests/test_torch_int8_ops.py
LN_SCALE_RTOL = 1e-6
# K5 in fp32 (the JAX test's own bound against its emulation is 1e-3;
# measured here far closer, as tests/test_torch_int8_ops.py states)
MLP_TOL = dict(atol=1e-5, rtol=1e-5)

ROWS = (1, 4, 129)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _codes_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FLIP_SHARE


def _scales_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=SCALE_MAXULP)


def _ln_scales_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=LN_SCALE_RTOL, atol=0)


def _case(m, k, n, seed):
    """int8 x (M, K) with row scales, a quantized (K, N) weight, bias (N,),
    residual (M, N), LN affine (N,), as numpy."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    sx = rng.uniform(0.01, 0.06, (m, 1)).astype(np.float32)
    wq, sw = j_quantize_weight(jnp.asarray(
        rng.standard_normal((k, n)).astype(np.float32) * 0.05))
    b = rng.standard_normal(n).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32) * 0.5 + 1
    be = rng.standard_normal(n).astype(np.float32) * 0.2
    return xq, sx, np.asarray(wq), np.asarray(sw), b, r, g, be


def _blocks(m, k, n):
    return dict(block_m=m, block_n=n, block_k=k, interpret=True)


# ------------------------------------------------------------------- K4

@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n,bias,residual", [(272, 136, True, True),
                                               (144, 520, False, False)])
def test_k4_plain_form_at_tile_edges(m, k, n, bias, residual):
    xq, sx, wq, sw, b, r, _, _ = _case(m, k, n, seed=m + k)
    want = j_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sw),
                    jnp.asarray(b) if bias else None, out_dtype=jnp.float32,
                    x_scale=jnp.asarray(sx),
                    residual=jnp.asarray(r) if residual else None,
                    **_blocks(m, k, n))
    got = int8_matmul_fused(_t(xq), _t(sx), _t(wq.T), _t(sw),
                            _t(b) if bias else None,
                            _t(r) if residual else None, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    # the split product the kernel may take instead: int32 partials over
    # whole ring steps that add up to the product exactly
    for splits in (2, 3):
        parts = split_partials(_t(xq), _t(wq.T), splits)
        assert parts.dtype == torch.int32 and parts.shape == (splits, m, n)
        assert torch.equal(parts.sum(0).double(), int_matmul(_t(xq), _t(wq.T)))


@pytest.mark.parametrize("m", ROWS)
def test_k4_ln_out_at_tile_edges(m):
    k, n = 272, 136
    xq, sx, wq, sw, b, r, g, be = _case(m, k, n, seed=7 + m)
    y_j, nq_j, ns_j = j_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(b),
        out_dtype=jnp.float32, x_scale=jnp.asarray(sx),
        residual=jnp.asarray(r), ln_out=(jnp.asarray(g), jnp.asarray(be), 1e-6),
        **_blocks(m, k, n))
    y, nq, ns = int8_matmul_fused(_t(xq), _t(sx), _t(wq.T), _t(sw), _t(b),
                                  _t(r), torch.float32,
                                  ln_out=(_t(g), _t(be), 1e-6))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FP32)
    assert tuple(ns.shape) == (m, 1)
    _ln_scales_close(ns, ns_j)
    _codes_close(nq, nq_j)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("n,block", [(136, 136), (1024, 512)])
def test_k4_q8_out_at_tile_edges(m, n, block):
    k = 144
    xq, sx, wq, sw, b, _, _, _ = _case(m, k, n, seed=11 + m + n)
    blocks = _blocks(m, k, block)
    yq_j, ys_j = j_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sw),
                          jnp.asarray(b), x_scale=jnp.asarray(sx),
                          q8_out=True, **blocks)
    yq, ys = int8_matmul_rows(_t(xq), _t(sx), _t(wq.T), _t(sw), _t(b),
                              q8_block=block)
    assert tuple(ys.shape) == (n // block, m, 1)
    _codes_close(yq, yq_j)
    _scales_close(ys, ys_j)


@pytest.mark.parametrize("m", ROWS)
def test_k4_float_input_at_tile_edges(m):
    """``prequantize=False``: the float x quantized with its row scales,
    x * (1 / s), then the product (the kernel's first launch and its
    product)."""
    k, n = 272, 136
    _, _, wq, sw, b, r, _, _ = _case(m, k, n, seed=3 + m)
    x = (np.random.default_rng(m).standard_normal((m, k)) * 3).astype(np.float32)
    want = j_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw),
                    jnp.asarray(b), prequantize=False, residual=jnp.asarray(r),
                    **_blocks(m, k, n))
    sx = torch.clamp(_t(x).abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    got = int8_matmul_rows(_t(x), sx, _t(wq.T), _t(sw), _t(b), _t(r),
                           out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


# ------------------------------------------------------------------- K5

def _mlp_case(m, d, hdim, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    xq, sx = j_ln_quant(jnp.asarray(x), jnp.ones((d,)), jnp.zeros((d,)), 1e-6,
                        interpret=True)
    w1q, s1 = j_quantize_weight(jnp.asarray(
        rng.standard_normal((d, hdim)).astype(np.float32) * 0.1))
    w2q, s2 = j_quantize_weight(jnp.asarray(
        rng.standard_normal((hdim, d)).astype(np.float32) * 0.1))
    b1 = rng.standard_normal(hdim).astype(np.float32) * 0.1
    b2 = rng.standard_normal(d).astype(np.float32) * 0.1
    res = rng.standard_normal((m, d)).astype(np.float32)
    g = rng.standard_normal(d).astype(np.float32) * 0.5 + 1
    be = rng.standard_normal(d).astype(np.float32) * 0.2
    return tuple(np.asarray(a) for a in (xq, sx, w1q, s1, b1, w2q, s2, b2, res,
                                         g, be))


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("hidden_blocks", [1, 2, 3])
def test_k5_at_tile_edges(m, hidden_blocks):
    """D = 144 (a multiple of 16, of no tile width), block_h 256; the chained
    ln_next where the hidden blocks are odd."""
    d, bh = 144, 256
    hdim = hidden_blocks * bh
    xq, sx, w1q, s1, b1, w2q, s2, b2, res, g, be = _mlp_case(m, d, hdim,
                                                              seed=m + hdim)
    chain = hidden_blocks % 2 == 1
    j = jnp.asarray
    want = j_int8_mlp(j(xq), j(sx), j(w1q), j(s1), j(b1), j(w2q), j(s2), j(b2),
                      j(res), block_m=32, block_h=bh, out_dtype=jnp.float32,
                      interpret=True,
                      ln_next=(j(g), j(be), 1e-6) if chain else None)
    got = int8_mlp(_t(xq), _t(sx), _t(w1q.T), _t(s1), _t(b1), _t(w2q.T),
                   _t(s2), _t(b2), _t(res), bh, torch.float32,
                   (_t(g), _t(be), 1e-6) if chain else None)
    if not chain:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLP_TOL)
        return
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **MLP_TOL)
    _ln_scales_close(got[2], want[2])
    _codes_close(got[1], want[1])


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_k5_halves_compose_in_group_order(groups):
    """The plain versions of the kernel's three launches: fc1's codes and
    (H / block_h, M) scales, fc2's per-group fp32 accumulators and the
    finish pass. One group is int8_mlp_reference bit for bit; more groups
    add each group's partial sum in group order (fp32 rounding apart)."""
    m, d, bh = 129, 144, 128
    hdim = 4 * bh
    xq, sx, w1q, s1, b1, w2q, s2, b2, res, g, be = _mlp_case(m, d, hdim, 5)
    t1 = (_t(xq), _t(sx), _t(w1q.T), _t(s1), _t(b1))
    hq, sh = mlp_fc1_reference(*t1, bh)
    assert hq.dtype == torch.int8 and tuple(hq.shape) == (m, hdim)
    assert sh.dtype == torch.float32 and tuple(sh.shape) == (hdim // bh, m)
    # each hidden block's codes reach 127 in magnitude somewhere in a row
    assert bool((hq.view(m, 4, bh).abs().amax(-1) == 127).all())
    part = mlp_fc2_reference(hq, sh, _t(w2q.T), bh, groups)
    assert tuple(part.shape) == (groups, m, d)
    ln = (_t(g), _t(be), 1e-6)
    got = mlp_finish_reference(part, _t(s2), _t(b2), _t(res), torch.float32, ln)
    want = int8_mlp_reference(*t1, _t(w2q.T), _t(s2), _t(b2), _t(res), bh,
                              torch.float32, ln)
    if groups == 1:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **MLP_TOL)
        _codes_close(got[1], want[1])


# ------------------------------------------------------ tiling rules

@pytest.mark.parametrize("m,k,n,finish,want", [
    (16384, 1024, 3072, False, (0, 1)),   # p16 qkv at B = 64
    (16384, 1024, 256, False, (0, 1)),    # p16 dict_proj: 256 tiles of 128
    (4096, 2048, 6144, False, (0, 1)),    # p32 qkv
    (1001, 1024, 1024, True, (1, 2)),     # 64-row tiles, then two K splits
    (256, 2560, 2560, True, (1, 2)),      # p128 proj + ln_out at B = 64
    (256, 2560, 7680, False, (1, 1)),     # p128 qkv: 240 tiles of 64 x 128
    (32, 2560, 2560, True, (2, 2)),       # p128 proj + ln_out at B = 8
    (4, 2560, 2560, True, (2, 4)),        # ... at B = 1: 40 tiles x 4
    (4, 2560, 7680, True, (2, 2)),        # q8_out at B = 1
    (4, 2560, 7680, False, (2, 1)),       # no finish pass: no split
    (1, 16, 8, True, (2, 1)),             # one ring step: nothing to split
])
def test_matmul_tiles_rule(m, k, n, finish, want):
    """The tile shape follows M (and, from 65 rows, whether 128-row tiles
    fill the 132 SMs); a launch with a finish pass splits K while the
    blocks are fewer than the SMs, each split keeping two ring steps or
    more."""
    tiles, splits = matmul_tiles(m, n, k, 132, finish)
    assert (tiles, splits) == want
    ranges = split_ranges(k, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a % int8_matmul.K_STEP == 0 and a <= b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))


@pytest.mark.parametrize("m,d,hdim,bh,want", [
    (16384, 1024, 4096, 256, (2, 0, 1)),
    (4096, 2048, 8192, 256, (2, 0, 1)),
    (256, 2560, 10240, 256, (2, 1, 1)),
    (32, 2560, 10240, 256, (3, 2, 1)),
    (4, 2560, 10240, 256, (3, 2, 2)),     # 40 fc2 tiles: two hidden groups
    (300, 1024, 4096, 128, (0, 1, 1)),
    (21, 2048, 1024, 512, (4, 2, 2)),
])
def test_mlp_tiles_rule(m, d, hdim, bh, want):
    got = mlp_tiles(m, d, hdim, bh, 132)
    assert got == want
    assert int8_block.FC1_TILES[got[0]][1] == bh
    assert (hdim // bh) % got[2] == 0
