"""The w4a8 products' plain versions against the JAX package, at the shapes
where the port's tiles end: K12 (``int4_matmul_fused`` with and without bias
and residual) at M = 1, 4, 17 and 129 rows (one row; fewer than the 16-row
tile; one past it; one past a 128-row tile), N a multiple of 8 but of no
tile width, K past one and two 128-value ring stages, scale groups of 128
and 256; K13 (``int4_mlp`` and the plain versions of its three launches) at
one, two and three hidden blocks and one to three hidden groups. Also the
tiling rules the wrappers pass to the kernels (``w4_matmul_tiles``,
``mlp4_tiles``) at the paths' shapes on 132 SMs.

Inputs are made with numpy from a seed and fed to both packages; each
quantizes the same float weight into the same codes and scales (its own
bytes); the Pallas kernels run in interpret mode with one block per
dimension, as tests/test_torch_int4_ops.py runs them; the port's wrappers
take their plain versions on CPU tensors. The two packages add the same
exact group terms in another order (ROADMAP "Order of sums in int4"), so
fp32 outputs agree to 1e-5 of the largest output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops import int4 as jint4
from tae_tpu.ops.pallas.int4_block import int4_mlp as j_int4_mlp
from tae_tpu.ops.pallas.int4_matmul import int4_matmul_fused as j_int4_matmul
from tae_tpu.ops.pallas.int8_block import ln_quant as j_ln_quant
from tae_tpu_torch.ops import int4
from tae_tpu_torch.ops.cuda import int4_block
from tae_tpu_torch.ops.cuda.int4_block import (
    int4_mlp, int4_mlp_reference, mlp4_fc1_reference, mlp4_fc2_reference,
    mlp4_finish_reference, mlp4_tiles)
from tae_tpu_torch.ops.cuda.int4_matmul import (
    W4_TILES, group_of, group_products, int4_matmul_fused,
    int4_matmul_reference, unpack_int4, w4_matmul_tiles)
from tae_tpu_torch.ops.cuda.int8_block import gelu_tanh

# fp32 outputs against the JAX kernels: the same exact terms in another
# order, each sum rounded to fp32 (measured 1e-7 of the largest output)
REL_TOL = 1e-5
BLOCK_H = 256
ROWS = (1, 4, 17, 129)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rel_to_max(got, want) -> float:
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


def _quantized(rng, k, n, group=None, scale=0.05):
    """A float (K, N) weight quantized by both packages: (JAX packed, JAX
    scales, port packed, port scales); the codes and scales are equal."""
    w = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    w4j, sj = jint4.quantize_weight_int4(jnp.asarray(w), group)
    w4, s = int4.quantize_weight_int4(torch.from_numpy(w.T.copy()), group)
    assert np.array_equal(s.numpy(), np.asarray(sj))
    return w4j, sj, w4, s


# ------------------------------------------------------------------- K12

@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n,group,bias,residual", [
    (256, 136, 128, True, True),      # two ring stages, two groups
    (512, 520, 256, False, False),    # four stages, two groups
    (768, 1000, 128, True, False)])   # six stages, six groups
def test_k12_at_tile_edges(m, k, n, group, bias, residual):
    rng = np.random.default_rng(7 * m + k + n)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    sx = rng.uniform(0.01, 0.06, (m, 1)).astype(np.float32)
    w4j, sj, w4, s = _quantized(rng, k, n, group)
    assert group_of(w4, s) == group
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    r = rng.standard_normal((m, n)).astype(np.float32) if residual else None
    want = j_int4_matmul(_j(xq), w4j, sj, _j(b), block_m=m, block_n=n,
                         out_dtype=jnp.float32, x_scale=_j(sx),
                         residual=_j(r), interpret=True)
    got = int4_matmul_fused(_t(xq), _t(sx), w4, s, _t(b), _t(r),
                            torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert _rel_to_max(got, want) <= REL_TOL
    # bf16 output: the same fp32 value rounded once
    assert torch.equal(int4_matmul_reference(_t(xq), _t(sx), w4, s, _t(b),
                                             _t(r), torch.bfloat16),
                       got.to(torch.bfloat16))


# ------------------------------------------------------------------- K13

def _mlp_case(m, d, hdim, seed):
    """int8 rows of a LayerNorm'd x, both weights quantized by both
    packages, biases and a residual, as (JAX args, port args)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    xq, sx = j_ln_quant(jnp.asarray(x), jnp.ones((d,)), jnp.zeros((d,)), 1e-6,
                        interpret=True)
    w1j, s1j, w1, s1 = _quantized(rng, d, hdim, scale=0.1)
    w2j, s2j, w2, s2 = _quantized(rng, hdim, d, scale=0.1)
    b1 = (rng.standard_normal(hdim) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    res = rng.standard_normal((m, d)).astype(np.float32)
    jargs = (xq, sx, w1j, s1j, _j(b1), w2j, s2j, _j(b2), _j(res))
    targs = (_t(xq), _t(sx), w1, s1, _t(b1), w2, s2, _t(b2), _t(res))
    return jargs, targs


def _mlp_loop(xq, sx, w1_4, s1, b1, w2_4, s2, b2, res, block_h, groups):
    """The plain version written out as one loop (the form it had before it
    was split into the kernel's launches): per run of hidden blocks, per
    block fc1 by groups, GELU, requantize, fc2 by groups times the block's
    scale; the runs added in order; + b2 + residual, in fp32."""
    g1, g2 = group_of(w1_4, s1), group_of(w2_4, s2)
    q1, q2 = unpack_int4(w1_4), unpack_int4(w2_4)
    n_h = q1.shape[0] // block_h
    total = None
    for run in range(groups):
        acc = torch.zeros((xq.shape[0], q2.shape[0]), dtype=torch.float32)
        for hb in range(run * (n_h // groups), (run + 1) * (n_h // groups)):
            sl = slice(hb * block_h, (hb + 1) * block_h)
            h = group_products(xq, q1[sl], s1[:, sl], g1)
            h = gelu_tanh(h * sx.reshape(-1, 1) + b1[sl])
            sh = (h.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
            hq = torch.round(h * (1.0 / sh)).clamp(-127.0, 127.0).to(torch.int8)
            gs = slice(hb * block_h // g2, (hb + 1) * block_h // g2)
            acc = acc + group_products(hq, q2[:, sl], s2[gs], g2) * sh
        total = acc if total is None else total + acc
    return total + b2 + res


@pytest.mark.parametrize("hidden_blocks,groups", [(1, 1), (2, 1), (2, 2),
                                                  (3, 1), (3, 3)])
def test_k13_launches_compose_into_the_plain_version(hidden_blocks, groups):
    """fc1's codes and (H / 256, M) scales, fc2's per-group fp32
    accumulators and the finish pass in a row are int4_mlp_reference, and
    that is the one-loop form, bit for bit, at every group count."""
    m, d = 17, 256
    hdim = hidden_blocks * BLOCK_H
    _, targs = _mlp_case(m, d, hdim, seed=hidden_blocks + 10 * groups)
    xq, sx, w1, s1, b1, w2, s2, b2, res = targs
    hq, sh = mlp4_fc1_reference(xq, sx, w1, s1, b1, BLOCK_H)
    assert hq.dtype == torch.int8 and tuple(hq.shape) == (m, hdim)
    assert sh.dtype == torch.float32 and tuple(sh.shape) == (hidden_blocks, m)
    # each hidden block's codes reach 127 in magnitude in every row
    assert bool((hq.view(m, hidden_blocks, BLOCK_H).abs().amax(-1) == 127).all())
    part = mlp4_fc2_reference(hq, sh, w2, s2, BLOCK_H, groups)
    assert part.dtype == torch.float32 and tuple(part.shape) == (groups, m, d)
    got = mlp4_finish_reference(part, b2, res, torch.float32)
    want = int4_mlp_reference(*targs, BLOCK_H, torch.float32, groups)
    assert torch.equal(got, want)
    assert torch.equal(want, _mlp_loop(*targs, BLOCK_H, groups))
    assert torch.equal(int4_mlp(*targs, BLOCK_H, torch.float32, groups), want)
    # another group count moves only the last bits of the fp32 sums
    one = int4_mlp_reference(*targs, BLOCK_H, torch.float32, 1)
    assert _rel_to_max(want, one.numpy()) <= REL_TOL


@pytest.mark.parametrize("m", (1, 17, 129))
@pytest.mark.parametrize("hidden_blocks", [2, 4])
def test_k13_against_the_jax_kernel(m, hidden_blocks, monkeypatch):
    """The JAX int4 MLP's hidden block pinned to the port's 256 (it is part
    of the numerics; the JAX kernel takes an even count of them). The two
    add the same terms in another order and XLA rounds ``h * sx + b1``
    once, so a hidden code whose value sits on a rounding tie may land on
    the neighbouring code and move its row by one hidden step times an fc2
    weight: rows beyond 1e-5 of the largest output are counted, at most one
    in 256 (at least one), none beyond 1e-2 of it."""
    monkeypatch.setenv("TAE_TPU_INT4_MLP_BH", str(BLOCK_H))
    d, hdim = 256, hidden_blocks * BLOCK_H
    jargs, targs = _mlp_case(m, d, hdim, seed=m + hdim)
    want = np.asarray(j_int4_mlp(*jargs, out_dtype=jnp.float32,
                                 interpret=True))
    got = int4_mlp(*targs, BLOCK_H, torch.float32).numpy()
    top = np.abs(want).max()
    diff = np.abs(got - want)
    off = (diff > REL_TOL * top).any(axis=1)
    assert off.sum() <= max(1, m // 256), off.sum()
    assert diff.max() <= 1e-2 * top, diff.max() / top


# ------------------------------------------------------ tiling rules

@pytest.mark.parametrize("m,k,n,want", [
    (16384, 1024, 3072, 0),   # p16 qkv at B = 64
    (16384, 1024, 1024, 0),   # p16 proj
    (256, 2560, 7680, 0),     # p128 qkv at B = 64
    (256, 2560, 2560, 0),     # p128 proj at B = 64
    (65, 1024, 1000, 0),      # one past the 16-row rule
    (64, 1024, 1000, 1),
    (32, 2560, 7680, 1),      # p128 at B = 8
    (32, 2560, 2560, 1),
    (4, 2560, 7680, 1),       # p128 at B = 1
    (4, 2560, 2560, 1),
])
def test_w4_matmul_tiles_rule(m, k, n, want):
    """16-row tiles up to 64 rows, 64-row tiles above (the 128-row tile of
    K4's rule measured slower wherever it would fill the card)."""
    assert w4_matmul_tiles(m, n, k) == want
    assert W4_TILES[want][0] == (16 if m <= 64 else 64)


def test_w4_matmul_tiles_refuses_what_the_kernel_does_not_take():
    for m, n, k in ((0, 8, 64), (4, 12, 256), (4, 8, 96), (4, 8, 32)):
        with pytest.raises(ValueError, match="int4_matmul_fused"):
            w4_matmul_tiles(m, n, k)


@pytest.mark.parametrize("m,d,hdim,want", [
    (16384, 1024, 4096, (0, 0, 1)),    # p16 at B = 64: 4096 fc2 tiles
    (256, 2560, 10240, (0, 0, 2)),     # p128 at B = 64: 160 fc2 tiles, 2 groups
    (65, 1024, 4096, (0, 0, 16)),      # one past the 16-row rule: 32 tiles
    (64, 1024, 4096, (1, 1, 8)),
    (32, 2560, 10240, (1, 1, 5)),      # p128 at B = 8: 80 fc2 tiles, 5 groups
    (4, 2560, 10240, (1, 1, 10)),      # p128 at B = 1: 40 fc2 tiles, 10 groups
    (1, 256, 1024, (1, 1, 4)),         # 4 fc2 tiles: a group per hidden block
])
def test_mlp4_tiles_rule(m, d, hdim, want):
    got = mlp4_tiles(m, d, hdim, 132)
    assert got == want
    rows = 16 if m <= 64 else None
    assert int4_block.FC1_TILES[got[0]] == (rows or 32, BLOCK_H)
    bm, bn = int4_block.FC2_TILES[got[1]]
    assert bm == (rows or 64)
    assert (hdim // BLOCK_H) % got[2] == 0
    # the groups fill at most FC2_WAVES blocks an SM
    assert -(-m // bm) * -(-d // bn) * got[2] <= int4_block.FC2_WAVES * 132 \
        or got[2] == 1


def test_mlp4_tiles_refuses_what_the_kernel_does_not_take():
    for m, d, hdim in ((0, 256, 1024), (4, 96, 1024), (4, 256, 1000)):
        with pytest.raises(ValueError, match="int4_mlp"):
            mlp4_tiles(m, d, hdim, 132)
