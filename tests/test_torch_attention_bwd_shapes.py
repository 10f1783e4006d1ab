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

