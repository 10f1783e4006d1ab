"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. On a
machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which these tests do not
use and the card's machine need not have.) ``chip_smoke.py`` checks the
kernels at the slice's shapes; these cover the edges: token counts that are
not a multiple of the kernels' 16-row tiles, both head dims, both dtypes,
both softmax forms, and the shapes the wrappers must refuse; for the int8
kernels, row counts off the 16/32/128-row blocks, the three model widths,
N and K off the 128 x 64 tiles, ``block_h`` values and both dtypes; for
the tiny-N and int8-output attention entries, token counts that do and do
not divide the 16-row tiles, batches that end inside a tile, both head dims.
"""

import pytest
import torch

from tae_tpu_torch.models.tae import TAE, TAEConfig
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.cuda.flash_attention import (
    fused_qkv_attention, fused_qkv_attention_reference)
from tae_tpu_torch.ops.cuda.int8_block import (
    int8_mlp, int8_mlp_reference, ln_quant, ln_quant_reference)
from tae_tpu_torch.ops.cuda.int8_matmul import (
    int8_matmul_fused, int8_matmul_reference, ln_chain_rows)
from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
from tae_tpu_torch.ops.cuda.wide_attention import (
    fused_qkv_attention_q8, fused_qkv_attention_q8_reference,
    fused_qkv_attention_wide, fused_qkv_attention_wide_q8,
    fused_qkv_attention_wide_q8_2d, fused_qkv_attention_wide_q8_2d_reference,
    fused_qkv_attention_wide_q8_reference, fused_qkv_attention_wide_reference)
from tae_tpu_torch.ops.layernorm import layer_norm_reference
from tae_tpu_torch.utils.dtypes import Policy

pytestmark = pytest.mark.cuda

# Kernel vs plain on the same inputs (as chip_smoke.py): both compute in
# fp32 and round once; fp32 summation order and the last bit of exp/rsqrt
# differ, which can flip one bf16 rounding (2^-8 relative) and stays near
# 1e-6 in fp32.
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
       torch.float32: dict(atol=2e-5, rtol=1e-4)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 8), (1000, 2048), (7, 5, 2560),
                                   (16384, 1024)])
def test_layer_norm_kernel_matches_plain(gen, shape, dtype, wdtype):
    d = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
    w = (torch.randn(d, generator=gen, device="cuda") + 1).to(wdtype)
    b = torch.randn(d, generator=gen, device="cuda").to(wdtype)
    before = fused_layer_norm.launches
    got = fused_layer_norm(x, w, b, 1e-6)
    assert fused_layer_norm.launches == before + 1
    _close(got, layer_norm_reference(x, w, b, 1e-6), dtype)


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,dh", [(1, 2, 64), (5, 3, 80), (17, 2, 64),
                                    (64, 4, 64), (100, 2, 80), (255, 2, 64),
                                    (256, 16, 64)])
def test_attention_kernel_matches_plain(gen, n, h, dh, dtype, serving):
    qkv = torch.randn((3, n, 3 * h * dh), generator=gen,
                      device="cuda").to(dtype)
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(qkv, h, serving=serving)
    assert fused_qkv_attention.launches == before + 1
    _close(got, fused_qkv_attention_reference(qkv, h, serving=serving), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_follows_the_serving_clamp(gen, dtype):
    """Scores far outside [-60, 45]: each kernel form equals its own plain
    form, and the two forms differ."""
    n, h, dh = 32, 2, 64
    qkv = torch.randn((2, n, 3 * h * dh), generator=gen, device="cuda")
    qkv[:, :, :h * dh] *= 30.0
    qkv = qkv.to(dtype)
    exact = fused_qkv_attention(qkv, h, serving=False)
    serving = fused_qkv_attention(qkv, h, serving=True)
    _close(exact, fused_qkv_attention_reference(qkv, h, serving=False), dtype)
    _close(serving, fused_qkv_attention_reference(qkv, h, serving=True), dtype)
    assert (exact.float() - serving.float()).abs().max() > 1e-2


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 100, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_layer_norm(x, torch.ones(100, device="cuda"),
                         torch.zeros(100, device="cuda"))
    with pytest.raises(TypeError):
        fused_layer_norm(x.half(), torch.ones(100, device="cuda"),
                         torch.zeros(100, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        fused_layer_norm(torch.randn(64, 8, device="cuda").t(),
                         torch.ones(64, device="cuda"),
                         torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError, match="head dim"):
        fused_qkv_attention(torch.randn(1, 4, 3 * 64, device="cuda"), 2)
    with pytest.raises(ValueError, match="tokens"):
        fused_qkv_attention(torch.randn(1, 257, 3 * 128, device="cuda"), 2)
    with pytest.raises(TypeError):
        fused_qkv_attention(torch.randn(1, 4, 3 * 128, device="cuda").half(), 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiny_tae_kernels_match_reference_backend(gen, dtype):
    """A small TAE whose encoder has dh 64 and decoder dh 80, so both head
    dims run: 2 K2 and 5 K1 launches per half, output within the slice's
    bound of chip_smoke.py (relative Frobenius error <= 2e-2)."""
    cfg = TAEConfig(img_size=64, patch_size=16, embed_dim=128, vocab_size=16,
                    depth=2, num_heads=2, decoder_embed_dim=160,
                    decoder_depth=2, decoder_num_heads=2)
    model = TAE(cfg, device="cuda").init_weights_(gen).to(dtype)
    pol = Policy(dtype, dtype)
    imgs = torch.randn((4, 3, 64, 64), generator=gen, device="cuda")
    k2, k1 = fused_qkv_attention.launches, fused_layer_norm.launches
    z = model.forward_encoder(imgs, policy=pol, serving=True)
    rec = model.forward_decoder(z, policy=pol, serving=True)
    assert fused_qkv_attention.launches - k2 == 4
    assert fused_layer_norm.launches - k1 == 10
    z_ref = model.forward_encoder(imgs, policy=pol, backend="reference",
                                  serving=True)
    rec_ref = model.forward_decoder(z, policy=pol, backend="reference",
                                    serving=True)
    for got, want in ((z, z_ref), (rec, rec_ref)):
        assert torch.isfinite(got).all()
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel <= 2e-2, rel


# ---------------------------------------------------------------------------
# int8 kernels (K3 ln_quant, K4 int8_matmul_fused, K5 int8_mlp)
# ---------------------------------------------------------------------------

# int8 codes of kernel and plain version: the fp32 value being rounded can
# differ in its last bits (summation order of the LN statistics, tanhf), so
# a value within that of a rounding tie lands on the neighbouring code.
# Codes may differ by 1 on at most this share of elements; scales are
# max-reductions of such values and agree to rtol 1e-5.
CODE_FLIP_SHARE = 1e-3


def _codes_close(got, want):
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1, int(diff.max())
    assert float((diff > 0).float().mean()) <= CODE_FLIP_SHARE


def _scales_close(got, want, rtol=1e-5):
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=0.0, rtol=rtol)


def _rand_i8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _affine(gen, d, dtype):
    g = (torch.randn(d, generator=gen, device="cuda") * 0.5 + 1).to(dtype)
    b = (torch.randn(d, generator=gen, device="cuda") * 0.2).to(dtype)
    return g, b


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(1, 8), (5, 1024), (1000, 2048), (37, 2560),
                                 (4096, 1024)])
def test_ln_quant_kernel_matches_plain(gen, m, d, dtype, wdtype):
    x = (torch.randn((m, d), generator=gen, device="cuda") * 3 + 1).to(dtype)
    w, b = _affine(gen, d, wdtype)
    before = ln_quant.launches
    q, s = ln_quant(x, w, b, 1e-6)
    assert ln_quant.launches == before + 1
    q_ref, s_ref = ln_quant_reference(x, w, b, 1e-6)
    _scales_close(s, s_ref)
    _codes_close(q, q_ref)


def _matmul_case(gen, m, k, n, dtype, bias, residual):
    xq, sx = _rand_i8(gen, (m, k)), torch.rand(
        (m, 1), generator=gen, device="cuda") * 0.05 + 0.01
    wq, sw = _rand_i8(gen, (n, k)), torch.rand(
        n, generator=gen, device="cuda") * 0.01 + 0.001
    b = torch.randn(n, generator=gen, device="cuda").to(dtype) if bias else None
    r = (torch.randn((m, n), generator=gen, device="cuda").to(dtype)
         if residual else None)
    return xq, sx, wq, sw, b, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias,residual", [(True, True), (True, False),
                                           (False, False)])
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (17, 48, 24), (129, 80, 136),
                                   (300, 1024, 3072), (256, 256, 1024),
                                   (511, 4096, 1024)])
def test_int8_matmul_kernel_matches_plain(gen, m, k, n, dtype, bias, residual):
    args = _matmul_case(gen, m, k, n, dtype, bias, residual)
    before = int8_matmul_fused.launches
    got = int8_matmul_fused(*args, out_dtype=dtype)
    assert int8_matmul_fused.launches == before + 1
    _close(got, int8_matmul_reference(*args, out_dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (33, 64, 136), (1000, 1024, 1024),
                                   (77, 2048, 2048), (50, 2560, 2560)])
def test_int8_matmul_ln_out_kernel_matches_plain(gen, m, k, n, dtype):
    args = _matmul_case(gen, m, k, n, dtype, True, True)
    ln = (*_affine(gen, n, dtype), 1e-6)
    assert ln_chain_rows(n) == (32 if n <= 1272 else 16)
    before = int8_matmul_fused.launches
    y, nq, ns = int8_matmul_fused(*args, out_dtype=dtype, ln_out=ln)
    assert int8_matmul_fused.launches == before + 1
    y_ref, nq_ref, ns_ref = int8_matmul_reference(*args, out_dtype=dtype,
                                                  ln_out=ln)
    _close(y, y_ref, dtype)
    _scales_close(ns, ns_ref)
    _codes_close(nq, nq_ref)


def _mlp_case(gen, m, d, hdim, dtype):
    xq = _rand_i8(gen, (m, d))
    sx = torch.rand((m, 1), generator=gen, device="cuda") * 0.02 + 0.005
    w1, w2 = _rand_i8(gen, (hdim, d)), _rand_i8(gen, (d, hdim))
    s1 = torch.rand(hdim, generator=gen, device="cuda") * 4e-4 + 1e-4
    s2 = torch.rand(d, generator=gen, device="cuda") * 4e-4 + 1e-4
    b1 = (torch.randn(hdim, generator=gen, device="cuda") * 0.1).to(dtype)
    b2 = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
    res = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    return xq, sx, w1, s1, b1, w2, s2, b2, res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("m,d,hdim,bh", [(1, 16, 128, 128), (33, 144, 512, 128),
                                         (70, 1024, 4096, 256),
                                         (300, 1024, 4096, 128),
                                         (40, 2048, 1024, 256),
                                         (21, 2048, 1024, 512),
                                         (21, 2560, 1024, 256),
                                         (2500, 128, 512, 128)])
def test_int8_mlp_kernel_matches_plain(gen, m, d, hdim, bh, chain, dtype):
    """The small row counts split the hidden blocks into groups (two
    kernels); 2500 rows are 79 row blocks, past half the SMs, and run the
    single kernel."""
    args = _mlp_case(gen, m, d, hdim, dtype)
    ln = (*_affine(gen, d, dtype), 1e-6) if chain else None
    before = int8_mlp.launches
    got = int8_mlp(*args, block_h=bh, out_dtype=dtype, ln_next=ln)
    assert int8_mlp.launches == before + 1
    want = int8_mlp_reference(*args, block_h=bh, out_dtype=dtype, ln_next=ln)
    if not chain:
        return _close(got, want, dtype)
    _close(got[0], want[0], dtype)
    # a hidden code on a rounding tie (tanhf) flips and moves its whole
    # output row, and so that row's LN scale, by one hidden quantization
    # step: a few 1e-4 relative on a few rows in ten thousand
    _scales_close(got[2], want[2], rtol=1e-3)
    _codes_close(got[1], want[1])


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(gen):
    args = _matmul_case(gen, 4, 24, 8, torch.bfloat16, True, True)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul_fused(*args)
    args = _matmul_case(gen, 4, 32, 12, torch.bfloat16, True, True)
    with pytest.raises(ValueError, match="multiple of 8"):
        int8_matmul_fused(*args)
    xq, sx, wq, sw, b, r = _matmul_case(gen, 4, 32, 16, torch.bfloat16, True,
                                        True)
    with pytest.raises(TypeError):
        int8_matmul_fused(xq, sx, wq, sw, b, r.float())
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_fused(xq, sx, wq.t().contiguous().t(), sw, b, r)
    with pytest.raises(TypeError):
        int8_matmul_fused(xq.float(), sx, wq, sw)
    wide = _matmul_case(gen, 4, 32, 3200, torch.bfloat16, True, True)
    ln = (*_affine(gen, 3200, torch.bfloat16), 1e-6)
    assert ln_chain_rows(3200) is None
    with pytest.raises(ValueError, match="ln_out"):
        int8_matmul_fused(*wide, ln_out=ln)
    # the dispatcher keeps the contract instead: y and no chained output
    y, yq, ys = int8.int8_linear(wide[0], wide[2], wide[3], wide[4],
                                 x_scale=wide[1], residual=wide[5], ln_out=ln)
    assert yq is None and ys is None and y.shape == (4, 3200)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_quant(torch.randn(4, 100, device="cuda"),
                 torch.ones(100, device="cuda"), torch.zeros(100, device="cuda"))
    mlp = _mlp_case(gen, 4, 64, 384, torch.bfloat16)
    with pytest.raises(ValueError, match="block_h"):
        int8_mlp(*mlp, block_h=256)
    with pytest.raises(ValueError, match="block_h"):
        int8_mlp(*mlp, block_h=64)
    big = _mlp_case(gen, 4, 2560, 1024, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        int8_mlp(*big, block_h=512)


@pytest.mark.parametrize("d,heads,ratio", [(128, 2, 4.0), (160, 2, 3.2)])
def test_tiny_int8_tae_kernels_match_reference_backend(gen, d, heads, ratio):
    """A small int8 TAE (16 tokens) through the kernels: per half one K3
    launch (the chains are on), 2 int8-output attention launches (K8), 2 K5
    and 5 (encoder) / 6 (decoder) K4 launches and no K1; outputs within the
    slice's bound of chip_smoke.py."""
    cfg = TAEConfig(img_size=64, patch_size=16, embed_dim=d, vocab_size=16,
                    depth=2, num_heads=heads, decoder_embed_dim=d,
                    decoder_depth=2, decoder_num_heads=heads, mlp_ratio=ratio)
    model = TAE(cfg, device="cuda").init_weights_(gen).to(torch.bfloat16)
    int8.prepare_serving_(model, "int8")
    pol = Policy(torch.bfloat16, torch.bfloat16)
    imgs = torch.randn((4, 3, 64, 64), generator=gen, device="cuda")
    fns = (ln_quant, int8_matmul_fused, int8_mlp, fused_qkv_attention_wide_q8,
           fused_layer_norm)
    before = [f.launches for f in fns]
    z = model.forward_encoder(imgs, policy=pol, serving=True)
    mid = [f.launches for f in fns]
    rec = model.forward_decoder(z, policy=pol, serving=True)
    after = [f.launches for f in fns]
    assert [b - a for a, b in zip(before, mid)] == [1, 5, 2, 2, 0]
    assert [b - a for a, b in zip(mid, after)] == [1, 6, 2, 2, 0]
    z_ref = model.forward_encoder(imgs, policy=pol, backend="reference",
                                  serving=True)
    rec_ref = model.forward_decoder(z, policy=pol, backend="reference",
                                    serving=True)
    for got, want in ((z, z_ref), (rec, rec_ref)):
        assert torch.isfinite(got).all()
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel <= 2e-2, rel


# ---------------------------------------------------------------------------
# tiny-N and int8-output attention (K6 wide, K7 q8, K8 wide_q8, K9 wide_q8_2d)
# ---------------------------------------------------------------------------

# (batch, tokens, heads, head dim): tokens that divide a 16-row tile (1, 2,
# 4, 8, 16), that a tile divides (32, 64) and neither (3, 5, 12, 24, 63);
# batches whose last tile is ragged; the registry's widths
WIDE_SHAPES = [(1, 1, 2, 64), (7, 4, 32, 80), (64, 4, 4, 80), (5, 2, 3, 64),
               (3, 8, 2, 64), (9, 3, 2, 80), (7, 5, 3, 64), (3, 12, 2, 80),
               (7, 16, 32, 80), (3, 24, 2, 64), (5, 32, 4, 64),
               (2, 63, 2, 80), (3, 64, 32, 64)]


def _attn_scales_close(got, want, dtype):
    """fp32: rtol 1e-5. bf16: the P.V product takes p rounded to bf16, and a
    p whose fp32 value differs in its last bits between kernel and plain
    version can round to the neighbouring bf16 value; one such flip moves
    that head's outputs of that row by up to 2^-7 * (p / l) * |v| and the
    row's scale with them. So rtol 1e-5 on all but 1% of the rows (at least
    one row) and 2e-2 (2^-7 times |v| / max|o| up to 2.5) on every row, as
    chip_smoke.py holds them."""
    if dtype == torch.float32:
        return _scales_close(got, want)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    rel = ((got - want).abs() / want.abs()).flatten()
    assert float(rel.max()) <= 2e-2, float(rel.max())
    assert int((rel > 1e-5).sum()) <= max(1, rel.numel() // 100)


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,dh", WIDE_SHAPES)
def test_wide_attention_kernel_matches_plain(gen, b, n, h, dh, dtype, serving):
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(dtype)
    before = fused_qkv_attention_wide.launches
    got = fused_qkv_attention_wide(qkv, h, serving=serving)
    assert fused_qkv_attention_wide.launches == before + 1
    _close(got, fused_qkv_attention_wide_reference(qkv, h, serving=serving),
           dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,dh", WIDE_SHAPES)
def test_wide_q8_attention_kernels_match_plain_and_each_other(gen, b, n, h, dh,
                                                              dtype):
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(dtype)
    k8, k9 = (fused_qkv_attention_wide_q8.launches,
              fused_qkv_attention_wide_q8_2d.launches)
    q3, s3 = fused_qkv_attention_wide_q8(qkv, h)
    q2, s2 = fused_qkv_attention_wide_q8_2d(qkv.reshape(b * n, -1), n, h)
    assert fused_qkv_attention_wide_q8.launches == k8 + 1
    assert fused_qkv_attention_wide_q8_2d.launches == k9 + 1
    assert q2.shape == (b * n, h * dh) and s2.shape == (b * n, 1)
    assert torch.equal(q2, q3.reshape(b * n, -1))        # bit-identical
    assert torch.equal(s2, s3.reshape(b * n, 1))
    q_ref, s_ref = fused_qkv_attention_wide_q8_reference(qkv, h)
    _attn_scales_close(s3, s_ref, dtype)
    _codes_close(q3, q_ref)
    q2_ref, s2_ref = fused_qkv_attention_wide_q8_2d_reference(
        qkv.reshape(b * n, -1), n, h)
    assert torch.equal(q2_ref, q_ref.reshape(b * n, -1))
    assert torch.equal(s2_ref, s_ref.reshape(b * n, 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,dh", [(1, 1, 2, 64), (3, 17, 2, 80),
                                      (2, 100, 3, 64), (2, 128, 4, 64),
                                      (1, 255, 2, 80), (3, 256, 16, 64)])
def test_q8_attention_kernel_matches_plain(gen, b, n, h, dh, dtype):
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(dtype)
    before = fused_qkv_attention_q8.launches
    q, s = fused_qkv_attention_q8(qkv, h)
    assert fused_qkv_attention_q8.launches == before + 1
    assert q.shape == (b, n, h * dh) and s.shape == (b, n, 1)
    q_ref, s_ref = fused_qkv_attention_q8_reference(qkv, h)
    _attn_scales_close(s, s_ref, dtype)
    _codes_close(q, q_ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_attention_kernels_follow_the_serving_clamp(gen, dtype):
    """Every score far below -60 (aligned q rows against anti-aligned k
    rows): the serving forms stay finite and equal their plain versions,
    the exact form equals its own."""
    b, n, h, dh = 6, 4, 2, 64
    c = h * dh
    qkv = torch.zeros((b, n, 3 * c), device="cuda")
    qkv[:, :, :c] = 40.0
    qkv[:, :, c:2 * c] = -40.0
    qkv[:, :, 2 * c:] = torch.randn((b, n, c), generator=gen, device="cuda")
    qkv = qkv.to(dtype)
    for serving in (True, False):
        got = fused_qkv_attention_wide(qkv, h, serving=serving)
        assert torch.isfinite(got).all()
        _close(got, fused_qkv_attention_wide_reference(qkv, h, serving=serving),
               dtype)
    q, s = fused_qkv_attention_wide_q8(qkv, h)
    q_ref, s_ref = fused_qkv_attention_wide_q8_reference(qkv, h)
    assert torch.isfinite(s).all()
    _attn_scales_close(s, s_ref, dtype)
    _codes_close(q, q_ref)


def test_wide_attention_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(2, 65, 3 * 128, device="cuda")
    for fn in (fused_qkv_attention_wide, fused_qkv_attention_wide_q8):
        with pytest.raises(ValueError, match="1..64 tokens"):
            fn(x, 2)
    with pytest.raises(ValueError, match="1..64 tokens"):
        fused_qkv_attention_wide_q8_2d(x.reshape(130, -1), 65, 2)
    with pytest.raises(ValueError, match="rows"):
        fused_qkv_attention_wide_q8_2d(torch.randn(10, 3 * 128, device="cuda"),
                                       4, 2)
    with pytest.raises(ValueError, match="tokens"):
        fused_qkv_attention_q8(torch.randn(1, 257, 3 * 128, device="cuda"), 2)
    with pytest.raises(ValueError, match="head dim"):
        fused_qkv_attention_q8(torch.randn(1, 4, 3 * 64, device="cuda"), 2)
    with pytest.raises(TypeError):
        fused_qkv_attention_wide(torch.randn(1, 4, 3 * 128,
                                             device="cuda").half(), 2)
    with pytest.raises(ValueError, match="output width"):
        fused_qkv_attention_q8(torch.randn(1, 4, 3 * 3200, device="cuda"), 50)
    with pytest.raises(ValueError, match="contiguous"):
        fused_qkv_attention_wide(
            torch.randn(2, 3 * 128, 4, device="cuda").transpose(1, 2), 2)


@pytest.mark.parametrize("attn_q8", [None, False])
@pytest.mark.parametrize("patch,tokens,d,ratio", [(32, 4, 160, 3.2),
                                                  (16, 16, 128, 4.0),
                                                  (8, 64, 160, 3.2)])
def test_tiny_n_int8_tae_kernels_match_reference_backend(gen, patch, tokens, d,
                                                         ratio, attn_q8):
    """A small int8 TAE at 4, 16 and 64 tokens, serving: with the rule the
    attention launches are K9 (4 tokens) or K8 and no K2, K6 or plain
    quantize; with attn_q8=False they are K6 (4 tokens) or K2. Outputs
    within the int8 slice's bound of chip_smoke.py."""
    from tae_tpu_torch.tokenizer import set_attn_q8

    cfg = TAEConfig(img_size=64, patch_size=patch, embed_dim=d, vocab_size=16,
                    depth=2, num_heads=2, decoder_embed_dim=d, decoder_depth=2,
                    decoder_num_heads=2, mlp_ratio=ratio)
    assert cfg.num_patches == tokens
    model = TAE(cfg, device="cuda").init_weights_(gen).to(torch.bfloat16)
    int8.prepare_serving_(model, "int8")
    set_attn_q8(model, attn_q8)
    pol = Policy(torch.bfloat16, torch.bfloat16)
    imgs = torch.randn((5, 3, 64, 64), generator=gen, device="cuda")
    fns = (fused_qkv_attention, fused_qkv_attention_wide,
           fused_qkv_attention_q8, fused_qkv_attention_wide_q8,
           fused_qkv_attention_wide_q8_2d)
    before = [f.launches for f in fns]
    z = model.forward_encoder(imgs, policy=pol, serving=True)
    rec = model.forward_decoder(z, policy=pol, serving=True)
    got = [f.launches - a for f, a in zip(fns, before)]
    if attn_q8 is False:
        assert got == ([0, 4, 0, 0, 0] if tokens < 8 else [4, 0, 0, 0, 0])
    else:
        assert got == ([0, 0, 0, 0, 4] if tokens < 8 else [0, 0, 0, 4, 0])
    z_ref = model.forward_encoder(imgs, policy=pol, backend="reference",
                                  serving=True)
    rec_ref = model.forward_decoder(z, policy=pol, backend="reference",
                                    serving=True)
    for out, want in ((z, z_ref), (rec, rec_ref)):
        assert torch.isfinite(out).all()
        rel = float((out.float() - want.float()).norm() / want.float().norm())
        assert rel <= 4e-2, rel
