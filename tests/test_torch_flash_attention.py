"""The port's unpacked attention (K16 forward, K17 backward: the qk_norm
block's attention) vs the JAX package's ``flash_attention``.

Inputs are made with numpy from a seed and fed to both packages. The JAX side
runs its Pallas kernels in interpret mode (``_fwd_call`` for the output and
the log-sum-exp, ``jax.vjp`` of ``flash_attention`` for the gradients, whose
backward is ``_bwd_kernel``), as tests/test_ops.py runs them; the port runs
the kernels' plain versions, which its wrappers take for CPU tensors, and
its ``autograd.Function`` whose two directions are those plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.attention import attention_xla as j_attention_xla
from tae_tpu.ops.pallas.flash_attention import _fwd_call as j_fwd_call
from tae_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from tae_tpu_torch.ops import attention as ops_attention
from tae_tpu_torch.ops.cuda import flash_attention as fa

# fp32 on both sides, sums in another order (tests/test_torch_train_ops.py)
FP32 = dict(atol=2e-5, rtol=2e-5)
FP32_GRAD = dict(atol=1e-4, rtol=1e-4)
# bf16 outputs: both sides compute in fp32 from the same bf16 operands and
# round once; a last-bit difference of the fp32 value flips that rounding by
# one bf16 ulp (2^-8 to 2^-7 of the value)
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)
# bf16 gradients: fp32 throughout on both sides, one rounding at the end,
# but from the forward's bf16 o (itself one rounding, possibly flipped),
# which enters delta = rowsum(dO * o): a few ulps of O(1) sums
BF16_GRAD = dict(atol=1e-2, rtol=1e-2)

CASES = [(n, dh) for dh in (64, 80) for n in (4, 16)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _inputs(b, h, n, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, n, dh)).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,dh", CASES)
def test_forward_and_lse_match_jax(n, dh, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, _ = _inputs(2, 3, n, dh, seed=n + dh)
    o_j, lse_j = j_fwd_call(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            dh ** -0.5, True, True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    o, lse = fa.flash_attention_reference(tq, tk, tv)
    assert o.dtype == tdt and tuple(o.shape) == (2, 3, n, dh)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 3, n)
    _close(o, o_j, **(FP32 if dtype == "float32" else BF16_ULP))
    _close(lse, lse_j[..., 0], **FP32)
    # the wrappers on CPU tensors: the plain version, no launch counted
    assert torch.equal(fa.flash_attention(tq, tk, tv), o)
    o2, lse2 = fa.flash_attention_fwd_lse(tq, tk, tv)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert fa.flash_attention.launches == fa.flash_attention_fwd_lse.launches == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,dh", CASES)
def test_gradients_match_jax_vjp(n, dh, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, do = _inputs(2, 2, n, dh, seed=3 * n + dh)
    y_j, vjp = jax.vjp(lambda *a: j_flash(*a, interpret=True),
                       *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    y = fa.flash_attention(tq, tk, tv)
    assert type(y.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(y, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    assert [g.dtype for g in got] == [tdt] * 3
    _close(y, y_j, **(FP32 if dtype == "float32" else BF16_ULP))
    for g, w in zip(got, want):
        _close(g, w, **(FP32_GRAD if dtype == "float32" else BF16_GRAD))
    assert fa.flash_attention_bwd.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_formula_matches_autograd_of_the_plain_forward(dtype):
    """K17's plain version (the explicit formulas, fp32 throughout) against
    torch autograd of the entry's reference backend (which rounds p to v's
    dtype ahead of P.V), dO in a non-contiguous layout."""
    q, k, v, do = _inputs(2, 2, 24, 64, seed=8)
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    tdo = torch.from_numpy(do.transpose(0, 2, 1, 3).copy()).to(
        dtype).transpose(1, 2)
    assert not tdo.is_contiguous()
    y_ref = ops_attention.attention(*ts, backend="reference")
    want = torch.autograd.grad(y_ref, ts, tdo)
    o, lse = fa.flash_attention_reference(*(t.detach() for t in ts))
    got = fa.flash_attention_backward_reference(*(t.detach() for t in ts), o,
                                                lse, tdo)
    via_fn = torch.autograd.grad(fa.flash_attention(*ts), ts, tdo)
    tol = FP32_GRAD if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    for g, f, w in zip(got, via_fn, want):
        assert g.dtype == dtype and torch.equal(g, f)
        _close(g, w, **tol)


@pytest.mark.parametrize("n", [4, 16, 33])
def test_attention_entry_matches_jax_on_both_backends(n):
    """``ops.attention.attention``: the kernel backend (K16 / K17's plain
    versions through the autograd function) and the reference backend (plain
    autograd) both equal the JAX XLA attention in fp32, forward and
    gradient."""
    q, k, v, do = _inputs(2, 4, n, 64, seed=n)
    y_j, vjp = jax.vjp(j_attention_xla, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    for backend in ("kernel", "reference"):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        y = ops_attention.attention(*ts, backend=backend)
        got = torch.autograd.grad(y, ts, torch.from_numpy(do))
        _close(y, y_j, **FP32)
        for g, w in zip(got, want):
            _close(g, w, **FP32_GRAD)
    with pytest.raises(ValueError, match="unknown backend"):
        ops_attention.attention(*ts, backend="xla")


def test_strided_operands_scale_and_shape_errors():
    """q, k, v as the qk_norm block hands them over (v a strided view of the
    packed projection output) give what contiguous copies give; an explicit
    scale is the JAX entry's; shapes that are not one (B, H, N, dh) raise."""
    rng = np.random.default_rng(4)
    b, n, h, dh = 2, 16, 4, 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * dh)).astype(
        np.float32))
    r = qkv.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    assert not r[2].is_contiguous()
    o, lse = fa.flash_attention_reference(r[0], r[1], r[2], scale=0.3)
    o_c, lse_c = fa.flash_attention_reference(*(t.contiguous() for t in r),
                                              scale=0.3)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    o_j = j_flash(*(jnp.asarray(t.contiguous().numpy()) for t in r), scale=0.3,
                  interpret=True)
    _close(o, o_j, **FP32)
    with pytest.raises(ValueError, match="one \\(B, H, N, dh\\) shape"):
        fa.flash_attention(r[0], r[1][:, :, :8], r[2])
    with pytest.raises(ValueError, match="one \\(B, H, N, dh\\) shape"):
        fa.flash_attention(qkv, qkv, qkv)
