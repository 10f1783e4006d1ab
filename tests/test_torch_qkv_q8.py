"""The port's int8-input attention route vs the JAX package: K4's ``q8_out``
output mode and its in-kernel quantize of a float x (``prequantize=False``),
the int8-input attention K15 (``fused_qkv_attention_i8``), and the int8
block with ``qkv_q8`` on (``int8_block_apply``'s ``use_i8_qkv`` branch).

Inputs are made with numpy from a seed. The JAX side runs its Pallas kernels
in interpret mode, as tests/test_ops.py runs them; the port runs the
kernels' plain versions, which its wrappers take for CPU tensors. The JAX
package stores weights (in, out), the port (out, in). ``int8_block_apply``
takes its ``use_i8_qkv`` branch only outside interpret mode, so the block is
held to a JAX composition of that branch's calls, each in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.nn import vit as jvit
from tae_tpu.ops.int8 import _block as j_block
from tae_tpu.ops.int8 import int8_linear as j_int8_linear
from tae_tpu.ops.int8 import quantize_params as j_quantize_params
from tae_tpu.ops.pallas.flash_attention import (
    fused_qkv_attention_i8 as j_qkv_i8_attention)
from tae_tpu.ops.pallas.int8_block import ln_quant as j_ln_quant
from tae_tpu.ops.pallas.int8_matmul import int8_matmul_fused as j_matmul
from tae_tpu_torch.ckpt.bridge import blocks_state_dict_from_jax
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.attention import QKV_Q8_MIN_TOKENS, qkv_i8_attention
from tae_tpu_torch.ops.cuda import flash_attention as fa
from tae_tpu_torch.ops.cuda import int8_matmul
from tae_tpu_torch.tokenizer import Tokenizer, set_qkv_q8

# bf16 outputs: both sides compute in fp32 from the same operands and round
# once; a last-bit difference flips that rounding by one bf16 ulp
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)
# fp32 outputs of the in-kernel quantize: the same exact int32 sums, the
# same epilogue products in the same order
FP32 = dict(atol=1e-6, rtol=1e-6)
# the block: int8 path against int8 path on the same int8 weights; a value
# within an ulp of a rounding tie takes the neighbouring code on one side
# (tests/test_torch_int8_model.py's CHAIN_REL, mean-abs relative)
CHAIN_REL = 5e-3
DIM, HEADS = 128, 2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x)


def _mean_rel(got, want) -> float:
    g, w = _np(got).astype(np.float32), _np(want).astype(np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).mean() / np.abs(w).mean())


def _matmul_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    sx = rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n), dtype=np.int8)          # JAX (in, out)
    sw = rng.uniform(1e-4, 5e-4, (n,)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    return xq, sx, wq, sw, b, r


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------- K4: q8_out, in-kernel x

@pytest.mark.parametrize("n", [384, 768, 3072, 6144, 7680, 480, 3096])
def test_q8_block_is_the_jax_block(n):
    """The scale block of ``q8_out`` is part of the contract with K15: the
    JAX package takes ``_block(N, 512)``."""
    assert int8.q8_block(n) == j_block(n, 512)


@pytest.mark.parametrize("m,k,n,bias,residual", [
    (64, 128, 384, True, False), (100, 256, 768, True, True),
    (32, 64, 1536, False, False), (7, 128, 3096, True, False)])
def test_q8_out_codes_and_scales_equal_jax(m, k, n, bias, residual):
    """int8 x with its row scales, the JAX default block: codes exactly
    equal (the same int32 sums, the fp32 epilogue in the same order, the
    scale's exact reciprocal). Scales within one fp32 ulp: XLA compiles the
    interpret-mode body with the first add contracted into an FMA and
    amax / 127 as a product with 1/127, where the port and the CUDA kernel
    round every product and sum and divide (the next test pins both)."""
    xq, sx, wq, sw, b, r = _matmul_case(m, k, n, seed=m + n)
    b, r = (b if bias else None), (r if residual else None)
    yq_j, ys_j = j_int8_linear(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sw),
        None if b is None else jnp.asarray(b), x_scale=jnp.asarray(sx),
        residual=None if r is None else jnp.asarray(r, jnp.bfloat16),
        q8_out=True, interpret=True)
    yq, ys = int8.int8_linear(
        _t(xq), _t(wq.T), _t(sw), None if b is None else _t(b),
        x_scale=_t(sx), residual=None if r is None else _t(r).bfloat16(),
        q8_out=True)
    bn = int8.q8_block(n)
    assert yq.dtype == torch.int8 and tuple(yq.shape) == (m, n)
    assert ys.dtype == torch.float32 and tuple(ys.shape) == (n // bn, m, 1)
    assert np.array_equal(_np(yq), np.asarray(yq_j))
    np.testing.assert_array_max_ulp(_np(ys), np.asarray(ys_j), maxulp=1)
    assert int8_matmul.int8_matmul_rows.launches == 0


@pytest.mark.parametrize("bias,residual", [
    (False, False), (True, False), (False, True), (True, True)])
def test_q8_out_scale_ulp_is_xla_contraction(bias, residual):
    """Where the ``q8_out`` scales part by an ulp, and why: the JAX ones are
    exactly max|y| * fp32(1/127) of y = fma(acc * sx, sw, first addend) (+
    the second), XLA's compilation of the interpret-mode body; the port's
    are exactly max|y| / 127 of the epilogue with every step rounded, as the
    Pallas source reads and the CUDA kernel computes."""
    m, k, n = 64, 128, 1024
    xq, sx, wq, sw, b, r = _matmul_case(m, k, n, seed=11)
    r = np.asarray(jnp.asarray(r, jnp.bfloat16).astype(jnp.float32))
    _, ys_j = j_int8_linear(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sw),
        jnp.asarray(b) if bias else None, x_scale=jnp.asarray(sx),
        residual=jnp.asarray(r, jnp.bfloat16) if residual else None,
        q8_out=True, interpret=True)
    _, ys = int8.int8_linear(
        _t(xq), _t(wq.T), _t(sw), _t(b) if bias else None, x_scale=_t(sx),
        residual=_t(r).bfloat16() if residual else None, q8_out=True)
    f32 = np.float32
    p = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(f32) * sx
    addends = [a for a, on in ((b, bias), (r, residual)) if on]
    y_round = p * sw
    for a in addends:
        y_round = y_round + a
    y_fma = p * sw
    if addends:                     # fp32 * fp32 is exact in fp64
        y_fma = (p.astype(np.float64) * sw + addends[0]).astype(f32)
        for a in addends[1:]:
            y_fma = y_fma + a

    def amax(y):
        return np.abs(y).reshape(m, n // 512, 512).max(-1).T[..., None]

    assert np.array_equal(np.asarray(ys_j), amax(y_fma) * f32(1 / 127))
    assert np.array_equal(_np(ys), amax(y_round) / f32(127))


def test_q8_out_of_a_float_x_and_an_explicit_block():
    """A float x is quantized per row first, as the JAX dispatcher does
    (``prequantize=True``); ``block_n`` sets the scale block (the JAX kernel
    takes it as ``block_n``); the plain version's leading dims are kept."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48, 128)).astype(np.float32)
    _, _, wq, sw, b, _ = _matmul_case(96, 128, 512, seed=4)
    yq_j, ys_j = j_int8_linear(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw),
                               jnp.asarray(b), q8_out=True, interpret=True)
    yq, ys = int8.int8_linear(_t(x), _t(wq.T), _t(sw), _t(b), q8_out=True)
    assert tuple(yq.shape) == (2, 48, 512)
    assert np.array_equal(_np(yq), np.asarray(yq_j))
    np.testing.assert_array_max_ulp(_np(ys), np.asarray(ys_j), maxulp=1)
    xq, sx = int8.quantize_rows(_t(x).reshape(96, 128))
    yq_j, ys_j = j_matmul(jnp.asarray(_np(xq)), jnp.asarray(wq), jnp.asarray(sw),
                          jnp.asarray(b), block_m=32, block_n=128, block_k=128,
                          x_scale=jnp.asarray(_np(sx)), q8_out=True,
                          interpret=True)
    yq, ys = int8.int8_linear(xq, _t(wq.T), _t(sw), _t(b), x_scale=sx,
                              q8_out=True, block_n=128)
    assert tuple(ys.shape) == (4, 96, 1)
    assert np.array_equal(_np(yq), np.asarray(yq_j))
    np.testing.assert_array_max_ulp(_np(ys), np.asarray(ys_j), maxulp=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_in_kernel_quantize_matches_jax(dtype, residual):
    """``prequantize=False``: the float x is quantized inside the kernel from
    its precomputed row scales, x * (1 / s) (the Pallas body's
    ``quantize_in_kernel``), not by the division of the prequantize pass."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    m, k, n = 64, 256, 384
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    _, _, wq, sw, b, r = _matmul_case(m, k, n, seed=9)
    y_j = j_matmul(jnp.asarray(x, jdt), jnp.asarray(wq), jnp.asarray(sw),
                   jnp.asarray(b), block_m=32, block_n=128, block_k=128,
                   prequantize=False,
                   residual=jnp.asarray(r, jdt) if residual else None,
                   interpret=True)
    tx = _t(x).to(tdt)
    y = int8.int8_linear(tx, _t(wq.T), _t(sw), _t(b), prequantize=False,
                         residual=_t(r).to(tdt) if residual else None)
    assert y.dtype == tdt and tuple(y.shape) == (m, n)
    np.testing.assert_allclose(_np(y), np.asarray(jnp.asarray(y_j, jnp.float32)),
                               **(FP32 if dtype == "float32" else BF16_ULP))
    # the plain version spelled out: row scales, x * (1 / s), the product
    sx = int8.row_scales(tx)
    xq = int8_matmul.quantize_with_scales(tx, sx)
    want = int8_matmul.int8_matmul_reference(
        xq, sx, _t(wq.T), _t(sw), _t(b), _t(r).to(tdt) if residual else None,
        tdt)
    assert torch.equal(y, want)


def test_row_form_refusals():
    xq, sx, wq, sw, b, _ = _matmul_case(8, 64, 64, seed=1)
    with pytest.raises(ValueError, match="exclude"):
        int8.int8_linear(_t(xq), _t(wq.T), _t(sw), x_scale=_t(sx), q8_out=True,
                         ln_out=(torch.ones(64), torch.zeros(64), 1e-6))
    with pytest.raises(ValueError, match="q8_block"):
        int8_matmul.int8_matmul_rows(_t(xq), _t(sx), _t(wq.T), _t(sw),
                                     q8_block=48)
    with pytest.raises(ValueError, match="int8_matmul_fused"):
        int8_matmul.int8_matmul_rows(_t(xq), _t(sx), _t(wq.T), _t(sw))
    with pytest.raises(TypeError, match="x_scale"):
        int8.int8_linear(_t(xq), _t(wq.T), _t(sw), q8_out=True)


# ------------------------------------------------------------------- K15

@pytest.mark.parametrize("b,n,h,dh,bn", [(2, 16, 2, 64, 384), (2, 24, 4, 32, 128),
                                         (1, 128, 2, 64, 384), (2, 9, 2, 80, 480),
                                         (3, 4, 4, 64, 256)])
def test_qkv_i8_attention_matches_jax(b, n, h, dh, bn):
    c3 = 3 * h * dh
    rng = np.random.default_rng(n + dh)
    qkv = rng.integers(-127, 128, (b, n, c3), dtype=np.int8)
    scales = rng.uniform(0.002, 0.03, (c3 // bn, b * n, 1)).astype(np.float32)
    want = j_qkv_i8_attention(jnp.asarray(qkv), jnp.asarray(scales), h,
                              interpret=True)
    got = fa.fused_qkv_attention_i8(_t(qkv), _t(scales), h)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, n, h * dh)
    np.testing.assert_allclose(_np(got), np.asarray(jnp.asarray(want,
                                                                jnp.float32)),
                               **BF16_ULP)
    assert torch.equal(qkv_i8_attention(_t(qkv), _t(scales), h), got)
    assert torch.equal(qkv_i8_attention(_t(qkv), _t(scales), h, "reference"),
                       got)
    assert fa.fused_qkv_attention_i8.launches == 0
    # the plain version is the serving attention of the dequantized qkv
    deq = fa.dequantize_qkv(_t(qkv), _t(scales))
    assert torch.equal(got, fa.fused_qkv_attention_reference(deq, h,
                                                             serving=True))


def test_qkv_i8_attention_refusals():
    rng = np.random.default_rng(0)
    qkv = _t(rng.integers(-127, 128, (1, 4, 3 * 2 * 80), dtype=np.int8))
    narrow = torch.full((3 * 2 * 80 // 48, 4, 1), 0.01)   # bn 48: dh 80 does not divide
    with pytest.raises(ValueError, match="must divide"):
        fa.fused_qkv_attention_i8(qkv, narrow, 2)
    with pytest.raises(ValueError, match="must divide"):
        j_qkv_i8_attention(jnp.asarray(_np(qkv)), jnp.asarray(_np(narrow)), 2,
                           interpret=True)
    with pytest.raises(TypeError, match="int8"):
        fa.fused_qkv_attention_i8(qkv.float(), torch.full((1, 4, 1), 0.01), 2)
    with pytest.raises(ValueError, match="scales"):
        fa.fused_qkv_attention_i8(qkv, torch.full((7, 4, 1), 0.01), 2)


# ----------------------------------------------------------------- block

@pytest.fixture(scope="module")
def int8_blocks():
    """Two JAX blocks (width 128, 2 heads of 64) in their int8 serving
    layout, and the port's stack on the same int8 weights."""
    cfg_t, cfg_j = vit.BlockConfig(DIM, HEADS), jvit.BlockConfig(DIM, HEADS)
    params = jvit.blocks_init(jax.random.key(2), cfg_j, 2)
    rng = np.random.default_rng(2)

    def jitter(tree):
        if isinstance(tree, dict) and set(tree) == {"scale", "bias"}:
            s = np.asarray(tree["scale"])
            return {"scale": jnp.asarray(s * rng.uniform(0.7, 1.4, s.shape)
                                         .astype(np.float32)),
                    "bias": jnp.asarray(rng.normal(0, 0.1, s.shape)
                                        .astype(np.float32))}
        if isinstance(tree, dict):
            return {k: jitter(v) for k, v in tree.items()}
        return tree

    qp = jax.tree.map(np.asarray, j_quantize_params(jitter(params)))
    layers = [jax.tree.map(lambda a, i=i: jnp.asarray(a[i]), qp)
              for i in range(2)]
    stack = vit.blocks(cfg_t, 2)
    int8.quantize_params_(stack, fill=False)
    stack.load_state_dict(blocks_state_dict_from_jax(qp), strict=True)
    return cfg_j, layers, stack.eval()


@pytest.fixture
def same_block_h(monkeypatch):
    """Pin the JAX MLP's hidden block to the port's (part of the numerics)."""
    monkeypatch.setenv("TAE_TPU_INT8_MLP_BH", str(int8.DEFAULT_BLOCK_H))


def j_qkv_q8_block(p, x, cfg, norm1_next=None):
    """``int8_block_apply``'s ``use_i8_qkv`` branch (tae_tpu/nn/vit.py
    :344-354), every kernel in interpret mode."""
    b, n, c = x.shape
    x2 = x.reshape(b * n, c)
    xq, sx = j_ln_quant(x2, p["norm1"]["scale"], p["norm1"]["bias"], cfg.ln_eps,
                        interpret=True)
    a = p["attn"]
    qkv_q, qkv_s = j_int8_linear(xq, a["qkv"]["w_q"], a["qkv"]["w_scale"],
                                 a["qkv"].get("b"), x_scale=sx, q8_out=True,
                                 interpret=True)
    y = j_qkv_i8_attention(qkv_q.reshape(b, n, 3 * c), qkv_s, cfg.num_heads,
                           interpret=True)
    x2 = jvit._qlinear(a["proj"], y.reshape(b * n, c), residual=x2,
                       out_dtype=x.dtype, interpret=True)
    out, ln_next = jvit._int8_mlp_half(p, x2, cfg, True, norm1_next=norm1_next)
    return out.reshape(b, n, c), ln_next


@pytest.mark.parametrize("chained", [False, True])
def test_qkv_q8_block_matches_jax_composition(int8_blocks, same_block_h,
                                              chained):
    cfg_j, layers, stack = int8_blocks
    n = QKV_Q8_MIN_TOKENS
    x = np.random.default_rng(13).standard_normal((2, n, DIM)).astype(np.float32)
    nxt = layers[1]["norm1"] if chained else None
    want, ln_j = j_qkv_q8_block(layers[0], jnp.asarray(x), cfg_j, nxt)
    blk = stack[0]
    blk.attn.qkv_q8 = True
    try:
        assert blk.takes_qkv_q8(n, serving=True)
        got, ln = blk.forward_int8(torch.from_numpy(x), serving=True,
                                   norm1_next=stack[1].norm1 if chained else None)
    finally:
        blk.attn.qkv_q8 = False
    rel = _mean_rel(got, want)
    assert rel <= CHAIN_REL, rel
    assert (ln is None) == (ln_j is None) == (not chained)
    if chained:
        assert _mean_rel(ln[0].float() * ln[1], np.asarray(ln_j[0], np.float32)
                         * np.asarray(ln_j[1])) <= CHAIN_REL
    # the default int8 route on the same block: close (another quantization
    # of the qkv activation), not the same
    other = blk.forward_int8(torch.from_numpy(x), serving=True)[0]
    assert 0 < _mean_rel(other, got) <= 5e-2


def test_qkv_q8_gate():
    """The route is taken only where the JAX package takes it: serving, an
    int8 qkv leaf, at least 128 tokens, no qk_norm, and a head dim dividing
    the scale block (p128's dh 80 against 512 fails), with the switch on."""
    def block(dim, heads, qk_norm=False, quantization="int8"):
        blk = vit.Block(vit.BlockConfig(dim, heads, qk_norm=qk_norm),
                        device="meta")
        if quantization == "int8":
            int8.quantize_params_(blk, fill=False)
        else:
            blk.attn.qkv = vit.Q4Linear(dim, 3 * dim, device="meta")
        blk.attn.qkv_q8 = True
        return blk

    p16 = block(1024, 16)
    assert p16.takes_qkv_q8(256, True) and p16.takes_qkv_q8(128, True)
    assert not p16.takes_qkv_q8(127, True) and not p16.takes_qkv_q8(256, False)
    assert not block(2560, 32).takes_qkv_q8(256, True)       # dh 80 ∤ 512
    assert block(2048, 32).takes_qkv_q8(256, True)            # dh 64 | 512
    assert not block(1024, 16, quantization="int4").takes_qkv_q8(256, True)
    assert not block(1024, 16, qk_norm=True).takes_qkv_q8(256, True)
    p16.attn.qkv_q8 = False
    assert not p16.takes_qkv_q8(256, True)
    assert vit.Attention(vit.AttentionConfig(64, 2), device="meta").qkv_q8 is False


def test_qkv_q8_tokenizer_switch():
    """``Tokenizer.from_checkpoint(qkv_q8=True)`` records the switch on every
    attention layer (off by default, as ``TAE_TPU_QKV_Q8`` is); at 256
    tokens it changes the int8 encode by the qkv activation's other
    quantization only; below 128 tokens it changes nothing."""
    kw = dict(embed_dim=128, depth=1, num_heads=2, decoder_embed_dim=128,
              decoder_depth=1, decoder_num_heads=2, device="cpu",
              quantization="int8", dtype=torch.float32)
    imgs = np.random.default_rng(5).integers(0, 256, (1, 3, 256, 256),
                                             dtype=np.uint8)
    base = Tokenizer.from_checkpoint("tae_patch16_vocab16_px256", **kw)
    on = Tokenizer.from_checkpoint("tae_patch16_vocab16_px256", qkv_q8=True,
                                   **kw)
    attn = [m for m in on.model.modules() if isinstance(m, vit.Attention)]
    assert len(attn) == 2 and all(m.qkv_q8 for m in attn)
    assert not any(m.qkv_q8 for m in base.model.modules()
                   if isinstance(m, vit.Attention))
    z, z0 = on.encode(imgs), base.encode(imgs)
    assert 0 < _mean_rel(z, z0) <= 5e-2
    set_qkv_q8(on.model, False)
    assert torch.equal(on.encode(imgs), z0)
    small = dict(kw, img_size=64)
    a = Tokenizer.from_checkpoint("tae_patch16_vocab16_px256", qkv_q8=True,
                                  **small)
    b = Tokenizer.from_checkpoint("tae_patch16_vocab16_px256", **small)
    x = imgs[:, :, :64, :64]
    assert torch.equal(a.encode(x), b.encode(x))
