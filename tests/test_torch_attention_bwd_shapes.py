"""The attention backward (K10 packed, K17 unpacked) at the token counts where
the bf16 backward body's row ranges and 16-row tiles end, vs the JAX package.

The card's body (``csrc/flash_attention_bwd.cu``) splits a head of n tokens
into row ranges per role, dK/dV blocks over keys and dQ blocks over query
rows, each range up to eight 16-row tiles (``partition``); the last tile of
each role is the only one masked. These tests take n at those edges (1, one
ragged tile; 129, one row past a range; 255, a ragged last tile of the
second range) at both head dims, in float32 and bfloat16. On the CPU the
port runs the plain versions, which have no tiles: the card tests
(tests/test_torch_cuda.py, chip_smoke.py) hold the body at the same counts.

Inputs are made with numpy from a seed and fed to both packages. The JAX side
is ``jax.vjp`` of ``fused_qkv_attention`` and of ``flash_attention`` (the
``_flash`` custom VJP) with their Pallas kernels in interpret mode, as
tests/test_ops.py runs them; the port runs its ``autograd.Function``s, whose
two directions are the kernels' plain versions on CPU tensors.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from tae_tpu.ops.pallas.flash_attention import fused_qkv_attention as j_fqa
from tae_tpu_torch.ops.cuda import flash_attention as fa

# fp32 on both sides, sums in another order; gradients sum up to 256 terms of
# size ~1 (tests/test_torch_train_ops.py, tests/test_torch_flash_attention.py)
FP32_GRAD = dict(atol=1e-4, rtol=1e-4)
# K10 in bf16: the JAX body upcasts every operand and rounds once; the port,
# like its tensor-core kernel, also rounds P and dS to bf16 ahead of the last
# three products (2^-9 of each term), then the common final rounding
# (tests/test_torch_train_ops.py)
K10_BF16 = dict(atol=1.5e-2, rtol=1.5e-2)
# K17 in bf16: fp32 throughout on both sides, one rounding at the end, from
# the forward's bf16 o (itself one rounding) inside delta
# (tests/test_torch_flash_attention.py)
K17_BF16 = dict(atol=1e-2, rtol=1e-2)

B, H = 2, 2
COUNTS = [(n, dh) for dh in (64, 80) for n in (1, 129, 255)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,dh", COUNTS)
def test_packed_attention_gradient_matches_jax(n, dh, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1000 + n + dh)
    qkv = rng.standard_normal((B, n, 3 * H * dh)).astype(np.float32)
    do = rng.standard_normal((B, n, H * dh)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: j_fqa(x, H, None, True, False),
                     jnp.asarray(qkv, jdt))
    (want,) = vjp(jnp.asarray(do, jdt))
    tq = torch.from_numpy(qkv).to(tdt).requires_grad_()
    y = fa.fused_qkv_attention(tq, H, serving=False)
    assert type(y.grad_fn).__name__ == "FusedQKVAttentionFnBackward"
    (got,) = torch.autograd.grad(y, tq, torch.from_numpy(do).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == qkv.shape
    _close(got, want, **(FP32_GRAD if dtype == "float32" else K10_BF16))
    assert fa.fused_qkv_attention_bwd.launches == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,dh", COUNTS)
def test_unpacked_attention_gradient_matches_jax(n, dh, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2000 + n + dh)
    q, k, v, do = (rng.standard_normal((B, H, n, dh)).astype(np.float32)
                   for _ in range(4))
    _, vjp = jax.vjp(lambda *a: j_flash(*a, interpret=True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    y = fa.flash_attention(tq, tk, tv)
    assert type(y.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(y, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == q.shape
        _close(g, w, **(FP32_GRAD if dtype == "float32" else K17_BF16))
    assert fa.flash_attention_bwd.launches == 0



# ------------------------------------------- the fp32 body's tiles and rule

# float32 at the edges of the tiled fp32 body (csrc/flash_attention_bwd.cu,
# attention_bwd_f32_tiled: 32-key chunks at dh 64, 16-key chunks at dh 80,
# from F32_BWD_TILED_MIN_TOKENS (56) tokens; below, the first design):
# either side of the rule (55, 56), one key past a chunk (17, 33), a chunk
# short of one key (31), whole chunks (16, 32) and the most tokens (256)
F32_EDGES = [(n, dh) for dh in (64, 80) for n in (16, 17, 31, 32, 33, 55, 56, 256)]


@pytest.mark.parametrize("n,dh", F32_EDGES)
def test_packed_f32_gradient_matches_jax_at_the_tiled_edges(n, dh):
    rng = np.random.default_rng(3000 + n + dh)
    qkv = rng.standard_normal((B, n, 3 * H * dh)).astype(np.float32)
    do = rng.standard_normal((B, n, H * dh)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: j_fqa(x, H, None, True, False), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(do))
    tq = torch.from_numpy(qkv).requires_grad_()
    y = fa.fused_qkv_attention(tq, H, serving=False)
    (got,) = torch.autograd.grad(y, tq, torch.from_numpy(do))
    assert got.dtype == torch.float32 and tuple(got.shape) == qkv.shape
    _close(got, want, **FP32_GRAD)
    assert fa.fused_qkv_attention_bwd.launches == 0


@pytest.mark.parametrize("n,dh", F32_EDGES)
def test_unpacked_f32_gradient_matches_jax_at_the_tiled_edges(n, dh):
    rng = np.random.default_rng(4000 + n + dh)
    q, k, v, do = (rng.standard_normal((B, H, n, dh)).astype(np.float32)
                   for _ in range(4))
    _, vjp = jax.vjp(lambda *a: j_flash(*a, interpret=True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    y = fa.flash_attention(tq, tk, tv)
    got = torch.autograd.grad(y, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == q.shape
        _close(g, w, **FP32_GRAD)
    assert fa.flash_attention_bwd.launches == 0


def _bwd_const(name: str) -> int:
    from tae_tpu_torch.ops.cuda import build

    text = (build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_f32_rule_mirrors_the_kernel_source():
    """F32_BWD_TILED_MIN_TOKENS and the chunks are the source's constants;
    the plan's C entry is bound."""
    from tae_tpu_torch.ops.cuda import build

    assert _bwd_const("kF32TiledMinTokens") == fa.F32_BWD_TILED_MIN_TOKENS
    assert 1 < fa.F32_BWD_TILED_MIN_TOKENS <= fa.MAX_TOKENS
    text = (build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    for dh, kc in fa.F32_BWD_CHUNK.items():
        assert re.search(rf"struct BwdTiles<{dh}> {{\s*static constexpr int KC = {kc},",
                         text), dh
    assert "tae_attention_bwd_f32_plan" in build.SIGNATURES


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("n", [1, 2, 16, 31, 32, 33, 34, 40, 63, 64, 65, 129, 200, 255, 256])
def test_the_f32_plan_at_its_edges(n, dh):
    """Below the rule the first design (8 warps, the head's K and V then Q
    and dO in shared memory); from it the tiled body: the shared memory
    counted here from scratch fits one block an SM at every token count,
    exactly the card's limit at 256 tokens and dh 64, and the chunks tile
    the keys with at most one part-filled chunk."""
    plan = fa.bwd_f32_plan(n, dh)
    assert plan.threads == 256
    assert plan.tiled == (n >= fa.F32_BWD_TILED_MIN_TOKENS)
    ld = dh + 4
    if plan.tiled:
        kc = plan.chunk
        assert kc == (32 if dh == 64 else 16) and kc % 4 == 0
        rows = -(-n // 8) * 8
        assert plan.smem == 4 * (2 * rows * ld + 2 * kc * ld + 2 * rows * (kc + 4)
                                 + 2 * rows)
        chunks = -(-n // kc)
        assert (chunks - 1) * kc < n <= chunks * kc
    else:
        assert plan.chunk == 0
        assert plan.smem == 4 * (2 * n * ld + 2 * (-(-n // 4) * 4) + 16 * ld + 16 * n)
    assert plan.smem <= fa.SMEM_LIMIT
    if n == 256 and dh == 64:
        assert plan.smem == fa.SMEM_LIMIT


@pytest.mark.parametrize("args", [(0, 64), (257, 64), (32, 96)])
def test_the_f32_plan_refuses_what_the_backward_does_not_take(args):
    assert fa.bwd_f32_plan(*args) is None
