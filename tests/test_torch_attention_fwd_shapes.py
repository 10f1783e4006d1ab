"""The attention forwards' plain versions vs the JAX package at the ragged
token counts the card kernel must mask: K2 (packed qkv: serving, exact and
LSE forms, in bf16 and fp32), K16 (unpacked q, k, v with v a strided view)
and K15 (int8 qkv with per-block scales).

The card kernel takes keys in chunks of 64 and tokens padded to a multiple
of 16, so the counts here sit on both sides of those edges (1, 63, 65, 129,
255, 256). Inputs are made with numpy from a seed and fed to both packages;
the JAX side runs its Pallas entries in interpret mode, as
tests/test_torch_ops.py does, and the port runs the plain versions its
wrappers take for CPU tensors (no launch is counted).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.pallas.flash_attention import _fwd_call as j_flash_fwd
from tae_tpu.ops.pallas.flash_attention import _packed_fwd_call as j_packed_fwd
from tae_tpu.ops.pallas.flash_attention import fused_qkv_attention as j_fqa
from tae_tpu.ops.pallas.flash_attention import (
    fused_qkv_attention_i8 as j_fqa_i8)
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda import flash_attention as fa

# bf16 outputs: p is rounded to bf16 ahead of P·V on both sides; an fp32
# last-bit difference in exp can flip one p's rounding (2^-8 of one term of
# a normalised sum), and the output rounds once to bf16: one ulp plus that,
# 1e-2 relative at |o| ~ 1 with an atol for small outputs
# (tests/test_torch_ops.py::test_packed_attention_bf16_matches_jax)
BF16 = dict(atol=4e-3, rtol=1e-2)
# lse: fp32 on both sides from exact products of bf16 operands; only the
# order of the sums differs (tests/test_torch_flash_attention.py)
LSE = dict(atol=2e-5, rtol=2e-5)

PACKED_SHAPES = [(n, 64) for n in (1, 63, 65, 129, 255, 256)] + [
    (n, 80) for n in (65, 255)]
# fp32: nothing is rounded; both sides sum exact fp32 products in another
# order and take their own exp (chip_smoke.py's fp32 bound, TOL["float32"])
F32 = dict(atol=2e-5, rtol=1e-4)
F32_SHAPES = [(n, dh) for dh in (64, 80) for n in (1, 63, 65, 129, 255, 256)]
B, H = 2, 2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _bf16_pair(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("form", ["serving", "exact", "lse"])
@pytest.mark.parametrize("n,dh", PACKED_SHAPES)
def test_packed_attention_forms_match_jax(n, dh, form):
    rng = np.random.default_rng(1000 * dh + n)
    jq, tq = _bf16_pair(rng.standard_normal((B, n, 3 * H * dh)).astype(np.float32))
    if form == "lse":
        o_j, lse_j = j_packed_fwd(jq, H, dh ** -0.5, True, True)
        o, lse = fa.fused_qkv_attention_fwd_lse(tq, H)
        assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, n)
        _close(lse, lse_j[..., 0], LSE)
        assert fa.fused_qkv_attention_fwd_lse.launches == 0
    else:
        serving = form == "serving"
        o_j = j_fqa(jq, H, interpret=True, serving=serving)
        o = fa.fused_qkv_attention(tq, H, serving=serving)
        assert fa.fused_qkv_attention.launches == 0
    assert o.dtype == torch.bfloat16 and tuple(o.shape) == (B, n, H * dh)
    _close(o, o_j, BF16)


@pytest.mark.parametrize("form", ["serving", "exact", "lse"])
@pytest.mark.parametrize("n,dh", F32_SHAPES)
def test_packed_attention_fp32_forms_match_jax(n, dh, form):
    """The fp32 forms the CUDA-core bodies run (the first design below
    F32_TILED_MIN_TOKENS tokens, the register-tiled body from there), on
    either side of their 64-key chunks and 64-row blocks."""
    rng = np.random.default_rng(7000 * dh + n)
    x = rng.standard_normal((B, n, 3 * H * dh)).astype(np.float32)
    jq, tq = jnp.asarray(x), torch.from_numpy(x)
    if form == "lse":
        o_j, lse_j = j_packed_fwd(jq, H, dh ** -0.5, True, True)
        o, lse = fa.fused_qkv_attention_fwd_lse(tq, H)
        assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, n)
        _close(lse, lse_j[..., 0], F32)
        assert fa.fused_qkv_attention_fwd_lse.launches == 0
    else:
        serving = form == "serving"
        o_j = j_fqa(jq, H, interpret=True, serving=serving)
        o = fa.fused_qkv_attention(tq, H, serving=serving)
        assert fa.fused_qkv_attention.launches == 0
    assert o.dtype == torch.float32 and tuple(o.shape) == (B, n, H * dh)
    _close(o, o_j, F32)


def test_f32_body_rule_mirrors_the_kernel_source():
    """The fp32 forward's shape rule (csrc/flash_attention.cu): the
    register-tiled body from kF32TiledMinTokens tokens, the first design
    below."""
    text = (build.CSRC_DIR / "flash_attention.cu").read_text()
    m = re.search(r"constexpr int kF32TiledMinTokens = (\d+);", text)
    assert m is not None and int(m.group(1)) == fa.F32_TILED_MIN_TOKENS
    assert "if (n < kF32TiledMinTokens) {" in text
    assert 1 < fa.F32_TILED_MIN_TOKENS <= fa.MAX_TOKENS


@pytest.mark.parametrize("n", [65, 255])
def test_unpacked_attention_with_strided_v_matches_jax(n):
    """q and k contiguous, v a strided view of the qkv projection's output,
    as the qk_norm block hands them to K16."""
    dh = 64
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((B, n, 3, H, dh)).astype(np.float32)
    t = torch.from_numpy(qkv).to(torch.bfloat16).permute(2, 0, 3, 1, 4)
    q, k, v = t[0].contiguous(), t[1].contiguous(), t[2]
    assert not v.is_contiguous()
    j = [jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3), jnp.bfloat16)
         for i in range(3)]
    o_j, lse_j = j_flash_fwd(*j, dh ** -0.5, True, True)
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    _close(o, o_j, BF16)
    _close(lse, lse_j[..., 0], LSE)
    assert torch.equal(fa.flash_attention(q, k, v), o)
    assert fa.flash_attention.launches == fa.flash_attention_fwd_lse.launches == 0


@pytest.mark.parametrize("n", [129, 256])
def test_int8_input_attention_matches_jax(n):
    """K15 with K4's q8_out scale block of 512 columns: 8 heads of 64 make
    the 1536-column qkv three blocks."""
    h, dh, bn = 8, 64, 512
    c3 = 3 * h * dh
    rng = np.random.default_rng(n)
    qkv = rng.integers(-127, 128, (B, n, c3), dtype=np.int8)
    scales = rng.uniform(0.002, 0.03, (c3 // bn, B * n, 1)).astype(np.float32)
    want = j_fqa_i8(jnp.asarray(qkv), jnp.asarray(scales), h, interpret=True)
    got = fa.fused_qkv_attention_i8(torch.from_numpy(qkv),
                                    torch.from_numpy(scales), h)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, n, h * dh)
    _close(got, want, BF16)
    assert fa.fused_qkv_attention_i8.launches == 0
