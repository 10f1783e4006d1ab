"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. On a
machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which these tests do not
use and the card's machine need not have.) ``chip_smoke.py`` checks the
kernels at the slice's shapes; these cover the edges: token counts that are
not a multiple of the kernels' 16-row tiles, both head dims, both dtypes,
both softmax forms, and the shapes the wrappers must refuse; for the int8
kernels, row counts off the 16-, 64- and 128-row tiles of their GEMM body,
every tile shape, K split and hidden split it picks, the three model
widths, N 8 past a tile and K 16 past a 128-byte ring step, ``block_h``
values, both dtypes and bit-equal reruns; for
the tiny-N and int8-output attention entries, token counts that do and do
not divide the 16-row tiles, batches that end inside a tile, both head dims;
for the training kernels (the stats and LSE forwards, the LayerNorm and
attention backwards), row counts off the 128-row chunks, every model width,
the LayerNorm row kernels' (K3, K11) plans against the library's at widths
where their register rows end,
token counts off the 16-row tiles, gradients in a non-contiguous layout, and
bit-equal results of two runs; for the int4 kernels (K12, K13), row counts
off the 16- and 64-row tiles of both tile shapes bit for bit, groups of 64,
128 and 256, every model width, each of K13's launches (fc1, fc2, finish)
against its plain version, and 1 to 40 hidden groups; for the codebook
search (K14), row and
code counts off the tiles, every latent width class (z resident and z tiled
over V), exact ties and the shapes the wrapper must refuse; for the unpacked
attention (K16, K17), both forms, every token count class, strided operands
and the qk_norm block; for K4's ``int8_matmul_rows`` entry (``q8_out``,
in-kernel quantize) and the int8-input attention (K15), ragged rows and every scale
block a model gives them; for the bf16 forward body that K2, K16 and K15
share, token counts on both sides of its 64-key chunks and exact forms on
scores far past the serving clip.
"""

import pytest
import torch

from tae_tpu_torch.models.tae import TAE, TAEConfig
from tae_tpu_torch.ops import int4, int8, quantizer
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda import quantizer as cuda_quantizer
from tae_tpu_torch.ops.cuda.int4_block import (
    int4_mlp, int4_mlp_reference, mlp4_fc1_reference, mlp4_fc2_reference,
    mlp4_finish_reference, mlp4_tiles)
from tae_tpu_torch.ops.cuda.int4_matmul import (int4_matmul_fused,
                                                int4_matmul_reference,
                                                pack_int4, w4_matmul_tiles)
from tae_tpu_torch.ops.cuda.flash_attention import (
    F32_TILED_MIN_TOKENS, flash_attention, flash_attention_backward_reference,
    flash_attention_bwd,
    flash_attention_fwd_lse, flash_attention_reference, fused_qkv_attention,
    fused_qkv_attention_backward_reference, fused_qkv_attention_bwd,
    fused_qkv_attention_fwd_lse, fused_qkv_attention_i8,
    fused_qkv_attention_i8_reference, fused_qkv_attention_lse_reference,
    fused_qkv_attention_reference)
from tae_tpu_torch.ops.cuda.int8_block import (
    int8_mlp, int8_mlp_reference, ln_quant, ln_quant_plan,
    ln_quant_plan_of_library, ln_quant_reference)
from tae_tpu_torch.ops.cuda.int8_matmul import (
    int8_matmul_fused, int8_matmul_reference, int8_matmul_rows,
    int8_matmul_rows_reference, ln_chain_rows)
from tae_tpu_torch.ops.cuda.layernorm import (
    bwd_plan, bwd_plan_of_library, fused_layer_norm, fused_layer_norm_bwd,
    fused_layer_norm_fwd_stats, fwd_plan, fwd_plan_of_library)
from tae_tpu_torch.ops.cuda.wide_attention import (
    fused_qkv_attention_q8, fused_qkv_attention_q8_reference,
    fused_qkv_attention_wide, fused_qkv_attention_wide_q8,
    fused_qkv_attention_wide_q8_2d, fused_qkv_attention_wide_q8_2d_reference,
    fused_qkv_attention_wide_q8_reference, fused_qkv_attention_wide_reference,
    q8_plan, q8_plan_of_library, rows_plan, rows_plan_of_library)
from tae_tpu_torch.ops.layernorm import (
    layer_norm_backward_reference, layer_norm_reference,
    layer_norm_stats_reference)
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


# the fp32 forward's bodies: the first design below F32_TILED_MIN_TOKENS
# tokens, the register-tiled one from there; 64-key chunks and 64-row
# blocks end at 63 / 64 / 65 and 129
F32_EDGES = [(n, dh) for dh in (64, 80)
             for n in (1, 31, 32, 33, 63, 64, 65, 128, 129, 255, 256)]


@pytest.mark.parametrize("n,dh", F32_EDGES)
def test_attention_f32_bodies_match_plain(gen, n, dh):
    """K2's serving, exact and LSE forms and K16's two forms (v a view of
    the packed projection) in fp32 against their plain versions; each call
    one launch, two runs bit-equal."""
    h = 3
    assert F32_TILED_MIN_TOKENS == 33
    qkv = torch.randn((2, n, 3 * h * dh), generator=gen, device="cuda")
    for serving in (True, False):
        got = fused_qkv_attention(qkv, h, serving=serving)
        _close(got, fused_qkv_attention_reference(qkv, h, serving=serving),
               torch.float32)
        assert torch.equal(got, fused_qkv_attention(qkv, h, serving=serving))
    o, lse = fused_qkv_attention_fwd_lse(qkv, h)
    o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
    _close(o, o_ref, torch.float32)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    r = qkv.view(2, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
    o_ref, lse_ref = flash_attention_reference(q, k, v)
    before = flash_attention_fwd_lse.launches
    o, lse = flash_attention_fwd_lse(q, k, v)
    assert flash_attention_fwd_lse.launches == before + 1
    _close(o, o_ref, torch.float32)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    _close(flash_attention(q, k, v), o_ref, torch.float32)


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


@pytest.mark.parametrize("form", ["plain", "ln_out", "q8_out", "float x"])
@pytest.mark.parametrize("m,k,n", [(1, 2560, 2560), (4, 1024, 3072),
                                   (17, 272, 136), (129, 1024, 1032),
                                   (256, 2560, 2560), (300, 1040, 264)])
def test_int8_matmul_tiles_and_splits_match_plain(gen, m, k, n, form):
    """The GEMM body at every tile shape and K split matmul_tiles picks
    (16-, 64- and 128-row tiles; 1 to 8 splits), ragged M, N 8 past a tile
    and K 16 past a 128-byte ring step; two runs bit-equal (int32 sums, no
    atomics)."""
    xq, sx, wq, sw, b, r = _matmul_case(gen, m, k, n, torch.bfloat16, True,
                                        True)
    if form == "float x":
        x = (torch.randn((m, k), generator=gen, device="cuda") * 3).bfloat16()
        sx = int8.row_scales(x)

        def run():
            return (int8_matmul_rows(x, sx, wq, sw, b, r),)
        want = (int8_matmul_rows_reference(x, sx, wq, sw, b, r),)
    elif form == "q8_out":
        block = 512 if n % 512 == 0 else n

        def run():
            return int8_matmul_rows(xq, sx, wq, sw, b, q8_block=block)
        want = int8_matmul_rows_reference(xq, sx, wq, sw, b, q8_block=block)
    else:
        ln = (*_affine(gen, n, torch.bfloat16), 1e-6) if form == "ln_out" else None

        def run():
            got = int8_matmul_fused(xq, sx, wq, sw, b, r, ln_out=ln)
            return got if ln else (got,)
        want = int8_matmul_reference(xq, sx, wq, sw, b, r, ln_out=ln)
        want = want if ln else (want,)
    got, again = run(), run()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    if form == "q8_out":
        _codes_close(got[0], want[0])
        _scales_close(got[1], want[1])
        return
    _close(got[0], want[0], torch.bfloat16)
    if form == "ln_out":
        _codes_close(got[1], want[1])
        _scales_close(got[2], want[2])


@pytest.mark.parametrize("m,d,hdim", [(1, 2560, 10240), (4, 2560, 10240),
                                      (17, 144, 768), (129, 1040, 512),
                                      (256, 2560, 10240), (2048, 1024, 4096)])
def test_int8_mlp_tiles_match_plain_and_rerun_bit_equal(gen, m, d, hdim):
    """K5's fc1 / fc2 / finish launches at every fc1 and fc2 tile shape and
    hidden split mlp_tiles picks, D 16 past a tile, one to forty hidden
    blocks; two runs bit-equal (the fp32 fold in a fixed order)."""
    args = _mlp_case(gen, m, d, hdim, torch.bfloat16)
    ln = (*_affine(gen, d, torch.bfloat16), 1e-6)
    got = int8_mlp(*args, ln_next=ln)
    again = int8_mlp(*args, ln_next=ln)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = int8_mlp_reference(*args, ln_next=ln)
    _close(got[0], want[0], torch.bfloat16)
    # as test_int8_mlp_kernel_matches_plain: a hidden code on a rounding tie
    # moves its row's LN scale by one hidden quantization step
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
        int8_mlp(*big, block_h=1024)


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
    """K8 and K9 each against its plain version; bit-equal to each other
    where both run the flat-row body (float32, or fewer tokens than the
    per-image body takes): from 16 tokens K8 in bf16 runs the per-image
    body, whose fp32 sums take another order."""
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(dtype)
    k8, k9 = (fused_qkv_attention_wide_q8.launches,
              fused_qkv_attention_wide_q8_2d.launches)
    q3, s3 = fused_qkv_attention_wide_q8(qkv, h)
    q2, s2 = fused_qkv_attention_wide_q8_2d(qkv.reshape(b * n, -1), n, h)
    assert fused_qkv_attention_wide_q8.launches == k8 + 1
    assert fused_qkv_attention_wide_q8_2d.launches == k9 + 1
    assert q2.shape == (b * n, h * dh) and s2.shape == (b * n, 1)
    if q8_plan(n, h, dh, dtype) is None:
        assert torch.equal(q2, q3.reshape(b * n, -1))    # bit-identical
        assert torch.equal(s2, s3.reshape(b * n, 1))
    q_ref, s_ref = fused_qkv_attention_wide_q8_reference(qkv, h)
    _attn_scales_close(s3, s_ref, dtype)
    _codes_close(q3, q_ref)
    q2_ref, s2_ref = fused_qkv_attention_wide_q8_2d_reference(
        qkv.reshape(b * n, -1), n, h)
    assert torch.equal(q2_ref, q_ref.reshape(b * n, -1))
    assert torch.equal(s2_ref, s_ref.reshape(b * n, 1))
    _attn_scales_close(s2, s2_ref, dtype)
    _codes_close(q2, q2_ref)


# K7 / K8 on the per-image body: (batch, tokens, heads, head dim) with the
# token counts where its 16-row tiles and 64-key chunks end, and head counts
# whose cluster's last rank takes one head (3, 17, 31) or two (12, 16, 24,
# 32)
Q8_BODY_SHAPES = [(3, 16, 17, 64), (2, 17, 3, 80), (3, 63, 12, 80),
                  (2, 64, 32, 64), (3, 65, 12, 64), (2, 129, 17, 80),
                  (1, 192, 31, 64), (2, 255, 24, 64), (2, 256, 16, 64),
                  (1, 256, 32, 80)]


@pytest.mark.parametrize("b,n,h,dh", Q8_BODY_SHAPES)
def test_q8_cluster_body_matches_plain_and_k2(gen, b, n, h, dh):
    """The int8 codes and scales against the plain version; the codes times
    the scales within half a step (their rounding) plus one bf16 rounding of
    K2's output on the same input, because both start from the same fp32 o;
    the library's plan equal to q8_plan's, and its clusters fit the card."""
    plan, clusters = q8_plan_of_library(n, h, dh)
    assert plan == q8_plan(n, h, dh) and plan is not None and clusters > 0
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(torch.bfloat16)
    fn = fused_qkv_attention_wide_q8 if n <= 64 else fused_qkv_attention_q8
    before = fn.launches
    q, s = fn(qkv, h)
    assert fn.launches == before + 1
    q_ref, s_ref = fused_qkv_attention_q8_reference(qkv, h)
    _attn_scales_close(s, s_ref, torch.bfloat16)
    _codes_close(q, q_ref)
    y = fused_qkv_attention(qkv, h, serving=True).double()
    dev = (q.double() * s.double() - y).abs()
    assert bool((dev <= 0.5 * s.double() * (1 + 2.0 ** -16)
                 + 2.0 ** -8 * y.abs()).all())


@pytest.mark.parametrize("b,n,h,dh", [(3, 256, 16, 64), (2, 129, 17, 80),
                                      (4, 64, 32, 64), (3, 16, 3, 80)])
def test_q8_cluster_body_dominant_last_head_and_zero_rows(gen, b, n, h, dh):
    """v of the last head scaled up puts every row's largest output in the
    cluster's last rank (a block quantizing with its own heads' maxima is
    caught); an image with v = 0 gives scale 1e-12 and codes 0."""
    c = h * dh
    qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda")
    qkv[..., 3 * c - dh:] *= 8.0
    qkv[0, :, 2 * c:] = 0.0
    qkv = qkv.to(torch.bfloat16)
    q, s = fused_qkv_attention_q8(qkv, h)
    q_ref, s_ref = fused_qkv_attention_q8_reference(qkv, h)
    _attn_scales_close(s, s_ref, torch.bfloat16)
    _codes_close(q, q_ref)
    assert bool((s[0] == 1e-12).all()) and not bool(q[0].any())


# The flat-row body in bf16 (K6, K9; K7 / K8 where the per-image body does
# not take the shape): (batch, tokens, heads, head dim) at p128's shape at
# B = 64, 8, 1, rows that leave the last tile part-filled, head counts whose
# last group (or cluster rank) takes fewer heads, 48 heads (3 a block),
# chunked key ranges (40 tokens)
ROWS_BODY_SHAPES = [(64, 4, 32, 80), (8, 4, 32, 80), (1, 4, 32, 80),
                    (7, 3, 17, 80), (5, 5, 48, 64), (3, 12, 1, 64),
                    (2, 40, 3, 80), (9, 8, 3, 64)]


@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("b,n,h,dh", ROWS_BODY_SHAPES)
def test_rows_body_plan_matches_the_library(gen, b, n, h, dh, q8):
    """The library's plan equal to rows_plan's, and the card holds at least
    one cluster (int8) or block of it at once."""
    plan, units = rows_plan_of_library(n, h, dh, q8)
    assert plan == rows_plan(n, h, dh, q8) and plan is not None and units > 0


@pytest.mark.parametrize("b,n,h,dh", ROWS_BODY_SHAPES)
def test_rows_body_kernels_match_plain_and_k8(gen, b, n, h, dh):
    """K9 and K6 (both forms) against their plain versions; below 16 tokens
    K8 runs the same body and equals K9 bit for bit."""
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(torch.bfloat16)
    flat = qkv.reshape(b * n, -1)
    before = fused_qkv_attention_wide_q8_2d.launches
    q2, s2 = fused_qkv_attention_wide_q8_2d(flat, n, h)
    assert fused_qkv_attention_wide_q8_2d.launches == before + 1
    q_ref, s_ref = fused_qkv_attention_wide_q8_2d_reference(flat, n, h)
    _attn_scales_close(s2, s_ref, torch.bfloat16)
    _codes_close(q2, q_ref)
    if q8_plan(n, h, dh) is None:
        q3, s3 = fused_qkv_attention_wide_q8(qkv, h)
        assert torch.equal(q3.reshape(b * n, -1), q2)
        assert torch.equal(s3.reshape(b * n, 1), s2)
    for serving in (True, False):
        got = fused_qkv_attention_wide(qkv, h, serving=serving)
        _close(got, fused_qkv_attention_wide_reference(qkv, h, serving=serving),
               torch.bfloat16)


@pytest.mark.parametrize("b,n,h,dh", [(2, 100, 48, 64), (1, 256, 36, 80),
                                      (2, 64, 128, 64), (3, 16, 100, 80)])
def test_rows_body_takes_int8_heads_past_the_cluster_body(gen, b, n, h, dh):
    """K7 / K8 in bf16 past 32 heads run the flat-row body (up to 8 heads a
    block, 64-key chunks above 64 tokens): against the plain version, two
    runs bit-equal; 129 heads raise."""
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(torch.bfloat16)
    assert q8_plan(n, h, dh) is None and rows_plan(n, h, dh, True) is not None
    fn = fused_qkv_attention_wide_q8 if n <= 64 else fused_qkv_attention_q8
    q, s = fn(qkv, h)
    q_ref, s_ref = fused_qkv_attention_q8_reference(qkv, h)
    _attn_scales_close(s, s_ref, torch.bfloat16)
    _codes_close(q, q_ref)
    q2, s2 = fn(qkv, h)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    with pytest.raises(ValueError, match="128 heads"):
        fused_qkv_attention_q8(torch.randn((1, 4, 3 * 129 * 64), device="cuda",
                                           dtype=torch.bfloat16), 129)


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


# ------------------------------------------------- training kernels (K1 with
# stats, K11, K2 with LSE, K10)

@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 8), (129, 64), (1000, 2048),
                                   (7, 5, 2560), (16384, 1024)])
def test_layer_norm_training_kernels_match_plain(gen, shape, dtype, wdtype):
    d = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
    w = (torch.randn(d, generator=gen, device="cuda") + 1).to(wdtype)
    b = torch.randn(d, generator=gen, device="cuda").to(wdtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    counts = (fused_layer_norm_fwd_stats.launches, fused_layer_norm_bwd.launches,
              fused_layer_norm.launches)
    y, mean, rstd = fused_layer_norm_fwd_stats(x, w, b, 1e-6)
    y_ref, mean_ref, rstd_ref = layer_norm_stats_reference(x, w, b, 1e-6)
    _close(y, y_ref, dtype)
    # fp32 statistics: summation order only
    torch.testing.assert_close(mean, mean_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, atol=1e-6, rtol=1e-5)
    dx, dw, db = fused_layer_norm_bwd(x, w, mean, rstd, dy)
    dx_ref, dw_ref, db_ref = layer_norm_backward_reference(x, w, mean, rstd, dy)
    _close(dx, dx_ref, dtype)
    # dw and db sum `rows` terms in fp32 in another order than the plain
    # version, then round once to the weight's dtype: the fp32 bound grows
    # with the square root of the rows (terms of size ~1)
    rows = x.numel() // d
    tol = (dict(atol=1e-2 * max(1.0, rows ** 0.5 / 8), rtol=1e-2)
           if wdtype == torch.bfloat16
           else dict(atol=2e-5 * max(1.0, rows ** 0.5), rtol=1e-4))
    assert dw.dtype == db.dtype == wdtype
    torch.testing.assert_close(dw.float(), dw_ref.float(), **tol)
    torch.testing.assert_close(db.float(), db_ref.float(), **tol)
    assert (fused_layer_norm_fwd_stats.launches, fused_layer_norm_bwd.launches,
            fused_layer_norm.launches) == (counts[0] + 1, counts[1] + 1,
                                           counts[2])
    # no atomics: a second run gives the same bits
    again = fused_layer_norm_bwd(x, w, mean, rstd, dy)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, (dx, dw, db)))


def test_layer_norm_autograd_takes_any_gradient_layout(gen):
    x = torch.randn((6, 40, 256), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    w = torch.ones(256, device="cuda", requires_grad=True)
    b = torch.zeros(256, device="cuda", requires_grad=True)
    y = fused_layer_norm(x, w.to(x.dtype), b.to(x.dtype))
    assert y.grad_fn is not None
    dy = torch.randn((40, 6, 256), generator=gen, device="cuda",
                     dtype=torch.bfloat16).transpose(0, 1)   # not contiguous
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), dy)
    x2 = x.detach().clone().requires_grad_()
    w2, b2 = (t.detach().clone().requires_grad_() for t in (w, b))
    y2 = layer_norm_reference(x2, w2.to(x.dtype), b2.to(x.dtype))
    rx, rw, rb = torch.autograd.grad(y2, (x2, w2, b2), dy)
    assert gw.dtype == gb.dtype == torch.float32
    _close(gx, rx, torch.bfloat16)
    # the kernel's dw / db are bf16 (the weight it was handed); autograd of
    # the plain forward sums in fp32 and never rounds: one bf16 rounding
    torch.testing.assert_close(gw, rw, atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(gb, rb, atol=5e-2, rtol=1e-2)


# The LayerNorm row kernels' plan edges (K3, K11; csrc/row_norm.cuh): one
# group and part of a second (8, 264), rows off a block and a chunk, the
# registered widths at p128's and p128_train's rows, K3's widest register
# row (4096) and the first widths past each register body (4104 for K3,
# 2568 for K11: the first designs' loops)
ROW_NORM_EDGES = [(1, 8), (129, 264), (7, 2048), (33, 2560), (256, 2560),
                  (3, 4096), (5, 4104), (130, 2568)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", ROW_NORM_EDGES)
def test_row_norm_kernels_at_their_plan_edges(gen, m, d, dtype):
    """The library's plans equal the Python mirrors; K3 and K11 against
    their plain versions, one launch count a call, K11's two runs
    bit-equal."""
    assert ln_quant_plan_of_library(m, d) == ln_quant_plan(m, d)
    assert bwd_plan_of_library(m, d) == bwd_plan(m, d)
    x = (torch.randn((m, d), generator=gen, device="cuda") * 3 + 1).to(dtype)
    g, b = _affine(gen, d, dtype)
    before = ln_quant.launches
    q, s = ln_quant(x, g, b, 1e-6)
    assert ln_quant.launches == before + 1
    q_ref, s_ref = ln_quant_reference(x, g, b, 1e-6)
    _scales_close(s, s_ref)
    _codes_close(q, q_ref)
    dy = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    _, mean, rstd = layer_norm_stats_reference(x, g, b, 1e-6)
    before = fused_layer_norm_bwd.launches
    dx, dw, db = fused_layer_norm_bwd(x, g, mean, rstd, dy)
    assert fused_layer_norm_bwd.launches == before + 1
    dx_ref, dw_ref, db_ref = layer_norm_backward_reference(x, g, mean, rstd, dy)
    _close(dx, dx_ref, dtype)
    # as test_layer_norm_training_kernels_match_plain: fp32 sums of m terms
    tol = (dict(atol=1e-2 * max(1.0, m ** 0.5 / 8), rtol=1e-2)
           if dtype == torch.bfloat16
           else dict(atol=2e-5 * max(1.0, m ** 0.5), rtol=1e-4))
    torch.testing.assert_close(dw.float(), dw_ref.float(), **tol)
    torch.testing.assert_close(db.float(), db_ref.float(), **tol)
    again = fused_layer_norm_bwd(x, g, mean, rstd, dy)
    assert all(torch.equal(a, c) for a, c in zip(again, (dx, dw, db)))


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", ROW_NORM_EDGES)
def test_layer_norm_fwd_at_its_plan_edges(gen, m, d, dtype, wdtype):
    """K1's plan equals the Python mirror; both entries against their plain
    versions, one launch count a call each, and the same y from both (one
    body: the stats form only adds mean and rstd)."""
    assert fwd_plan_of_library(m, d) == fwd_plan(m, d)
    x = (torch.randn((m, d), generator=gen, device="cuda") * 3 + 1).to(dtype)
    w = (torch.randn(d, generator=gen, device="cuda") + 1).to(wdtype)
    b = torch.randn(d, generator=gen, device="cuda").to(wdtype)
    before = (fused_layer_norm.launches, fused_layer_norm_fwd_stats.launches)
    y = fused_layer_norm(x, w, b, 1e-6)
    y2, mean, rstd = fused_layer_norm_fwd_stats(x, w, b, 1e-6)
    assert (fused_layer_norm.launches, fused_layer_norm_fwd_stats.launches) == (
        before[0] + 1, before[1] + 1)
    _close(y, layer_norm_reference(x, w, b, 1e-6), dtype)
    y_ref, mean_ref, rstd_ref = layer_norm_stats_reference(x, w, b, 1e-6)
    _close(y2, y_ref, dtype)
    torch.testing.assert_close(mean, mean_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,dh", [(9, 2, 64), (16, 32, 80), (17, 2, 64),
                                    (64, 4, 64), (100, 2, 80), (255, 2, 64),
                                    (256, 16, 64), (256, 2, 80)])
def test_attention_training_kernels_match_plain(gen, n, h, dh, dtype):
    b, c = 3, h * dh
    qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, n, c), generator=gen, device="cuda").to(dtype)
    counts = (fused_qkv_attention_fwd_lse.launches,
              fused_qkv_attention_bwd.launches, fused_qkv_attention.launches)
    o, lse = fused_qkv_attention_fwd_lse(qkv, h)
    o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
    _close(o, o_ref, dtype)
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    # fp32 on both sides from exact bf16 products: summation order and expf
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    dqkv = fused_qkv_attention_bwd(qkv, o, lse, do, h)
    want = fused_qkv_attention_backward_reference(qkv, o, lse, do, h)
    _close(dqkv, want, dtype)
    assert (fused_qkv_attention_fwd_lse.launches,
            fused_qkv_attention_bwd.launches,
            fused_qkv_attention.launches) == (counts[0] + 1, counts[1] + 1,
                                              counts[2])
    assert torch.equal(dqkv, fused_qkv_attention_bwd(qkv, o, lse, do, h))


# token counts at the edges of the bf16 backward body's 16-row tiles and
# 128-row ranges (``partition`` in csrc/flash_attention_bwd.cu), both head dims
BWD_EDGES = [(50, 64), (1, 64), (17, 64), (129, 64), (255, 64), (1, 80),
             (17, 80), (129, 80), (255, 80)]


@pytest.mark.parametrize("n,dh", BWD_EDGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_autograd_matches_plain_autograd(gen, dtype, n, dh):
    """The whole Function against autograd of the plain forward, with the
    gradient handed over in a non-contiguous layout; every element of dqkv
    is written (the output buffer starts as NaN-free garbage either way, so
    compare all of it)."""
    b, h = 2, 3
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(dtype).requires_grad_()
    do = torch.randn((n, b, h * dh), generator=gen,
                     device="cuda").to(dtype).transpose(0, 1)
    y = fused_qkv_attention(qkv, h, serving=False)
    assert y.grad_fn is not None
    (g,) = torch.autograd.grad(y, qkv, do)
    q2 = qkv.detach().clone().requires_grad_()
    (g2,) = torch.autograd.grad(
        fused_qkv_attention_reference(q2, h, serving=False), q2, do)
    assert bool(torch.isfinite(g).all())
    # autograd of the plain forward rounds elsewhere (p to bf16 ahead of
    # P.V, its gradient through that cast, no rounding of dS): bf16 gets two
    # roundings of room, fp32 the kernel bound
    tol = (dict(atol=3e-2, rtol=3e-2) if dtype == torch.bfloat16
           else TOL[torch.float32])
    torch.testing.assert_close(g.float(), g2.float(), **tol)


def test_training_wrappers_refuse_and_carry_gradients(gen):
    qkv = torch.randn((2, 16, 3 * 128), generator=gen, device="cuda",
                      dtype=torch.bfloat16).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_qkv_attention(qkv, 2, serving=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_qkv_attention_wide(qkv[:, :4].contiguous(), 2, serving=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_qkv_attention_q8(qkv, 2)
    assert fused_qkv_attention(qkv, 2, serving=False).grad_fn is not None
    y = fused_qkv_attention_wide(qkv[:, :4].contiguous(), 2, serving=False)
    assert y.grad_fn is not None
    with torch.no_grad():
        assert fused_qkv_attention(qkv, 2, serving=True).grad_fn is None


@pytest.mark.parametrize("remat", [False, True])
def test_tiny_tae_train_step_kernels_match_reference_backend(gen, remat):
    """One forward and backward of a small trainable TAE (dh 64 encoder, dh
    80 decoder) through the kernels against backend="reference": launch
    counts of the four training entries, loss and gradients."""
    cfg = TAEConfig(img_size=64, patch_size=16, embed_dim=128, vocab_size=16,
                    depth=2, num_heads=2, decoder_embed_dim=160,
                    decoder_depth=2, decoder_num_heads=2)
    model = TAE(cfg, device="cuda", trainable=True).init_weights_(gen)
    imgs = torch.randn((4, 3, 64, 64), generator=gen, device="cuda")
    fns = (fused_layer_norm_fwd_stats, fused_layer_norm_bwd,
           fused_qkv_attention_fwd_lse, fused_qkv_attention_bwd,
           fused_layer_norm, fused_qkv_attention)
    before = [f.launches for f in fns]
    loss, _ = model(imgs, policy=Policy(), remat=remat)
    loss.backward()
    got = [f.launches - b for f, b in zip(fns, before)]
    extra = (8, 4) if remat else (0, 0)     # the blocks' forwards, once more
    assert got == [10 + extra[0], 10, 4 + extra[1], 4, 0, 0]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    loss_ref, _ = model(imgs, policy=Policy(), backend="reference")
    loss_ref.backward()
    assert abs(float(loss) - float(loss_ref)) <= 2e-2 * float(loss_ref)
    for k, p in model.named_parameters():
        rel = float((grads[k] - p.grad).norm() / p.grad.norm().clamp_min(1e-12))
        # bf16 through 2 + 2 blocks; the two sides round P and dS differently
        assert rel <= 5e-2, (k, rel)


# ---------------------------------------------------------------------------
# int4 (w4a8): K12 int4_matmul_fused, K13 int4_mlp
# ---------------------------------------------------------------------------

# fp32 outputs of K12: kernel and plain version add the same exact terms in
# the same order with every product and sum rounded separately, so they
# agree to the last bits; bf16 outputs round the same fp32 value once.
W4_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-6),
          torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def _w4(gen, n, k, group):
    q = torch.randint(-7, 8, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand((k // group, n), generator=gen, device="cuda") * 4e-3 \
        + 1e-3
    return pack_int4(q), scale


def _w4_matmul_case(gen, m, k, n, group, dtype, bias, residual):
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((m, 1), generator=gen, device="cuda") * 0.05 + 0.01
    w4, scale = _w4(gen, n, k, group)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype) if bias else None
    r = (torch.randn((m, n), generator=gen, device="cuda").to(dtype)
         if residual else None)
    return xq, sx, w4, scale, b, r, dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias,residual", [(True, True), (False, False),
                                           (True, False)])
@pytest.mark.parametrize("m,k,n,group", [
    (1, 256, 8, 128), (4, 2560, 7680, 256), (32, 2560, 2560, 256),
    (100, 512, 1000, 256), (256, 2560, 7680, 256), (33, 256, 72, 64),
    (1001, 1024, 3072, 256), (4100, 1024, 1024, 128), (129, 2048, 136, 256)])
def test_int4_matmul_kernel_matches_plain(gen, m, k, n, group, dtype, bias,
                                          residual):
    args = _w4_matmul_case(gen, m, k, n, group, dtype, bias, residual)
    before = int4_matmul_fused.launches
    got = int4_matmul_fused(*args)
    assert int4_matmul_fused.launches == before + 1
    want = int4_matmul_reference(*args)
    assert got.dtype == want.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), **W4_TOL[dtype])


@pytest.mark.parametrize("m,k,n,group,tile", [
    (16, 384, 136, 128, 1), (17, 256, 72, 64, 1), (64, 512, 1000, 256, 1),
    (65, 512, 1000, 256, 0), (129, 384, 520, 64, 0), (129, 256, 8456, 128, 0),
    (257, 512, 8456, 64, 0)])
def test_int4_matmul_tile_edges_bit_equal(gen, m, k, n, group, tile):
    """K12 at the edges of each tile w4_matmul_tiles picks (rows one past a
    tile, N 8 past one, K past a 128-value ring stage, 64-wide groups that
    fold every two k32 steps on every tile): fp32 and bf16 outputs equal to
    the plain version bit for bit (the same fp32 terms in the same order),
    and two runs alike."""
    assert w4_matmul_tiles(m, n, k) == tile
    for dtype in (torch.float32, torch.bfloat16):
        args = _w4_matmul_case(gen, m, k, n, group, dtype, True, True)
        got = int4_matmul_fused(*args)
        assert torch.equal(got, int4_matmul_fused(*args))
        assert torch.equal(got, int4_matmul_reference(*args))


def test_int4_matmul_wrapper_refuses_what_the_kernel_does_not_take(gen):
    xq, sx, w4, scale, b, r, _ = _w4_matmul_case(gen, 4, 256, 16, 128,
                                                 torch.bfloat16, True, True)
    with pytest.raises(TypeError):
        int4_matmul_fused(xq, sx, w4.to(torch.int8), scale)
    with pytest.raises(TypeError):
        int4_matmul_fused(xq, sx, w4, scale, b, r.float())
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul_fused(xq, sx, w4.t().contiguous().t(), scale)
    with pytest.raises(ValueError, match="multiple of 64"):
        int4_matmul_fused(xq, sx, w4, scale.repeat(4, 1)[:8].contiguous())
    with pytest.raises(ValueError, match="multiple of 8"):
        int4_matmul_fused(xq, sx, w4[:12].contiguous(),
                          scale[:, :12].contiguous())
    with pytest.raises(RuntimeError, match="forward-only"):
        int4_matmul_fused(xq, sx, w4, scale, b.requires_grad_())
    # a width where int4_ok is false never reaches K12: its linears are int8
    assert not int4.int4_ok(128) and int4.int4_ok(256)


def _w4_mlp_case(gen, m, d, hdim, g1, g2, dtype):
    xq = torch.randint(-127, 128, (m, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((m, 1), generator=gen, device="cuda") * 0.02 + 0.005
    w1, s1 = _w4(gen, hdim, d, g1)
    w2, s2 = _w4(gen, d, hdim, g2)
    s1, s2 = s1 * 0.05, s2 * 0.05
    b1 = (torch.randn(hdim, generator=gen, device="cuda") * 0.1).to(dtype)
    b2 = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
    r = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    return xq, sx, w1, s1, b1, w2, s2, b2, r


def _mlp4_close(got, want, dtype):
    """Kernel and plain version add the same terms in one order, so fp32
    outputs agree to rounding (tanhf aside: 1e-5), except on rows where a
    hidden code sat on a rounding tie and flipped: such a row moves by one
    hidden quantization step times an fc2 weight, below 1e-2 of the largest
    output; at most one row in 256 (at least one) may."""
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if dtype == torch.bfloat16:
        return torch.testing.assert_close(g, w, atol=1e-2, rtol=1e-2)
    err = (g - w).abs()
    rows_off = (err > 1e-5 + 1e-5 * w.abs()).any(dim=1)
    assert int(rows_off.sum()) <= max(1, got.shape[0] // 256), int(rows_off.sum())
    assert float(err.max()) <= 1e-2 * float(w.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d,hdim,g1,g2,groups", [
    (1, 256, 1024, 128, 256, 1), (4, 2560, 10240, 256, 256, None),
    (4, 2560, 10240, 256, 256, 40), (100, 1024, 4096, 256, 256, None),
    (40, 256, 1024, 128, 256, 2), (33, 512, 2048, 256, 128, 1),
    (256, 2560, 10240, 256, 256, None), (1001, 1024, 4096, 256, 256, 1),
    (17, 2048, 8192, 256, 64, 4)])
def test_int4_mlp_kernel_matches_plain(gen, m, d, hdim, g1, g2, groups, dtype):
    args = _w4_mlp_case(gen, m, d, hdim, g1, g2, dtype)
    if groups is None:
        groups = mlp4_tiles(
            m, d, hdim, torch.cuda.get_device_properties(0).multi_processor_count)[2]
    before = int4_mlp.launches
    got = int4_mlp(*args, 256, dtype, groups)
    assert int4_mlp.launches == before + 1
    _mlp4_close(got, int4_mlp_reference(*args, 256, dtype, groups), dtype)


def test_int4_mlp_wrapper_refuses_what_the_kernel_does_not_take(gen):
    args = _w4_mlp_case(gen, 4, 256, 1024, 128, 256, torch.bfloat16)
    with pytest.raises(ValueError, match="block_h"):
        int4_mlp(*args, block_h=512)
    with pytest.raises(ValueError, match="split"):
        int4_mlp(*args, groups=3)
    with pytest.raises(TypeError):
        int4_mlp(*args[:8], args[8].float())
    with pytest.raises(RuntimeError, match="forward-only"):
        int4_mlp(*args[:8], args[8].requires_grad_())
    # no width cap: the accumulator lives in registers, not shared memory
    wide = _w4_mlp_case(gen, 4, 4096, 1024, 256, 256, torch.bfloat16)
    _mlp4_close(int4_mlp(*wide), int4_mlp_reference(*wide), torch.bfloat16)


def _mlp4_launches(args, groups, fc1, fc2):
    """K13's C entry with its workspaces kept: (out, hq, sh, part or
    None)."""
    xq, sx, w1, s1, b1, w2, s2, b2, r = args
    (m, d), hdim = xq.shape, w1.shape[0]
    hq = torch.empty((m, hdim), dtype=torch.int8, device="cuda")
    sh = torch.empty((hdim // 256, m), dtype=torch.float32, device="cuda")
    part = (torch.empty((groups, m, d), dtype=torch.float32, device="cuda")
            if groups > 1 else None)
    out = torch.empty_like(r)
    rc = build.library().tae_int4_mlp_fwd(
        xq.data_ptr(), sx.data_ptr(), w1.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        r.data_ptr(), out.data_ptr(), m, d, hdim, 2 * w1.shape[1] // s1.shape[0],
        2 * w2.shape[1] // s2.shape[0], build.dtype_code(r.dtype),
        build.dtype_code(b1.dtype), hq.data_ptr(), sh.data_ptr(),
        build.ptr(part), groups, fc1, fc2, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "tae_int4_mlp_fwd")
    torch.cuda.synchronize()
    return out, hq, sh, part


@pytest.mark.parametrize("m,d,hdim,g2,groups", [
    (4, 2560, 10240, 256, 2), (17, 512, 2048, 128, 1), (129, 1024, 4096, 64, 4),
    (300, 256, 1024, 256, 1), (33, 512, 2048, 256, 8),
    (2048, 1024, 4096, 128, 1)])
def test_int4_mlp_launches_match_their_plain_halves(gen, m, d, hdim, g2, groups):
    """Each of K13's launches against its plain version: fc1's codes and
    scales (tanhf against torch.tanh: a code on a rounding tie may flip);
    fc2 on the kernel's own codes, whose fp32 partials are the plain
    version's bit for bit (the same terms in the same order); the finish
    pass (or fc2's epilogue with one group) on them, bit for bit."""
    args = _w4_mlp_case(gen, m, d, hdim, 256, g2, torch.float32)
    fc1, fc2, _ = mlp4_tiles(
        m, d, hdim, torch.cuda.get_device_properties(0).multi_processor_count)
    out, hq, sh, part = _mlp4_launches(args, groups, fc1, fc2)
    want_hq, want_sh = mlp4_fc1_reference(*args[:5])
    _codes_close(hq, want_hq)
    _scales_close(sh, want_sh)
    want_part = mlp4_fc2_reference(hq, sh, args[5], args[6], 256, groups)
    if part is not None:
        assert torch.equal(part, want_part)
    assert torch.equal(out, mlp4_finish_reference(want_part, args[7], args[8],
                                                  torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_int4_mlp_hidden_groups_match_plain(gen, groups, dtype):
    """K13 with its hidden blocks dealt to 1, 2, 4 and 8 groups over fc2's
    grid, against the plain version summing the same groups."""
    args = _w4_mlp_case(gen, 33, 512, 2048, 256, 256, dtype)
    got = int4_mlp(*args, 256, dtype, groups)
    _mlp4_close(got, int4_mlp_reference(*args, 256, dtype, groups), dtype)
    assert torch.equal(got, int4_mlp(*args, 256, dtype, groups))


def test_tiny_int4_tae_kernels_match_reference_backend(gen):
    """A small int4 TAE (16 tokens, width 256) through the kernels: per half
    two K3 launches a block (no LN chain), 2 K12 a block, one K13 and one
    int8-output attention launch (K8) a block, the head through K1 and K4;
    outputs within the slice's bound of chip_smoke.py."""
    cfg = TAEConfig(img_size=64, patch_size=16, embed_dim=256, vocab_size=16,
                    depth=2, num_heads=4, decoder_embed_dim=256,
                    decoder_depth=2, decoder_num_heads=4)
    model = TAE(cfg, device="cuda").init_weights_(gen).to(torch.bfloat16)
    int8.prepare_serving_(model, "int4")
    pol = Policy(torch.bfloat16, torch.bfloat16)
    imgs = torch.randn((4, 3, 64, 64), generator=gen, device="cuda")
    fns = (ln_quant, int4_matmul_fused, int4_mlp, fused_qkv_attention_wide_q8,
           int8_matmul_fused, fused_layer_norm, int8_mlp)
    before = [f.launches for f in fns]
    z = model.forward_encoder(imgs, policy=pol, serving=True)
    mid = [f.launches for f in fns]
    rec = model.forward_decoder(z, policy=pol, serving=True)
    after = [f.launches for f in fns]
    assert [b - a for a, b in zip(before, mid)] == [4, 4, 2, 2, 1, 1, 0]
    assert [b - a for a, b in zip(mid, after)] == [4, 4, 2, 2, 2, 1, 0]
    z_ref = model.forward_encoder(imgs, policy=pol, backend="reference",
                                  serving=True)
    rec_ref = model.forward_decoder(z, policy=pol, backend="reference",
                                    serving=True)
    for got, want in ((z, z_ref), (rec, rec_ref)):
        assert torch.isfinite(got).all()
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel <= 2e-2, rel


# ---------------------------------------------------------------------------
# VQ bottleneck: K14 nearest_code
# ---------------------------------------------------------------------------

def _ids_close(z, cb, got, want, share):
    """Ids equal on all but ``share`` of the rows; where they differ the
    chosen code is as near as the plain version's to 1e-4 relative (squared
    distances in fp64): the two add the same fp32 products in another
    order, so only a near-tie can fall the other way."""
    assert got.dtype == want.dtype == torch.int64 and got.shape == want.shape
    off = got != want
    assert float(off.float().mean()) <= share, float(off.float().mean())
    if off.any():
        zz, c = z[off].double(), cb.to(z.dtype).double()
        d_got = (zz - c[got[off]]).square().sum(-1)
        d_want = (zz - c[want[off]]).square().sum(-1)
        assert bool((d_got <= d_want * (1 + 1e-4) + 1e-9).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,v", [
    (32, 64, 16), (100, 130, 32), (16, 8192, 256), (1, 1, 8), (1000, 777, 64),
    (300, 100, 24), (70, 200, 1024), (40, 90, 2048), (4096, 8192, 256),
    (257, 65, 136)])
def test_nearest_code_kernel_matches_plain(gen, m, k, v, dtype):
    z = torch.randn((m, v), generator=gen, device="cuda").to(dtype)
    cb = torch.randn((k, v), generator=gen, device="cuda").to(dtype)
    before = cuda_quantizer.nearest_code.launches
    got = cuda_quantizer.nearest_code(z, cb)
    assert cuda_quantizer.nearest_code.launches == before + 1
    want = cuda_quantizer.nearest_code_reference(z, cb)
    assert int(got.min()) >= 0 and int(got.max()) < k
    _ids_close(z, cb, got, want, 1e-3 if dtype == torch.bfloat16 else 0.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nearest_code_kernel_breaks_ties_to_the_lowest_index(gen, dtype):
    cb = torch.randn((700, 64), generator=gen, device="cuda").to(dtype)
    cb[77], cb[300], cb[699] = cb[5], cb[5], cb[5]        # one code four times
    cb[650] = cb[64]                                      # across tiles
    z = torch.randn((50, 64), generator=gen, device="cuda").to(dtype)
    z[::2], z[1] = cb[5], cb[64]
    got = cuda_quantizer.nearest_code(z, cb)
    assert bool((got[::2] == 5).all()) and int(got[1]) == 64
    assert torch.equal(got, cuda_quantizer.nearest_code_reference(z, cb))
    # every distance equal: index 0
    zero = torch.zeros((40, 32), device="cuda", dtype=dtype)
    assert int(cuda_quantizer.nearest_code(z[:, :32].contiguous(),
                                           zero).abs().max()) == 0


def test_nearest_code_dispatch_and_gradients(gen):
    z = torch.randn((3, 5, 64), generator=gen, device="cuda",
                    requires_grad=True)
    cb = torch.randn((90, 64), generator=gen, device="cuda",
                     requires_grad=True)
    before = cuda_quantizer.nearest_code.launches
    ids = quantizer.nearest_code(z, cb)                  # does not trip on grad
    assert cuda_quantizer.nearest_code.launches == before + 1
    assert ids.shape == (3, 5) and not ids.requires_grad
    assert torch.equal(ids, quantizer.nearest_code(z, cb, backend="reference"))
    assert cuda_quantizer.nearest_code.launches == before + 1
    zq, aux = quantizer.vq_ste(z, cb)
    (zq.sum() * 2.0 + aux).backward()
    assert z.grad is not None and cb.grad is not None
    assert float(cb.grad.abs().sum()) > 0
    # wide latents take the kernel too (z tiled over V)
    wide = torch.randn((4, 2056), generator=gen, device="cuda")
    wide_cb = torch.randn((9, 2056), generator=gen, device="cuda")
    assert torch.equal(quantizer.nearest_code(wide, wide_cb),
                       quantizer.nearest_code(wide, wide_cb,
                                              backend="reference"))
    assert cuda_quantizer.nearest_code.launches == before + 3
    with pytest.raises(ValueError, match="multiple of"):
        cuda_quantizer.nearest_code(wide[:, :6].contiguous(),
                                    wide[:3, :6].contiguous())


@pytest.mark.parametrize("v", [4096, 2056])
def test_nearest_code_wide_latents_raise_on_the_card(gen, v):
    """V = 4096 is a registered latent width (p64 / p128, vocab 4096): on the
    card it no longer raises; every dispatcher launches the kernel, which
    tiles z over V, and agrees with the plain version."""
    z = torch.randn((6, v), generator=gen, device="cuda").bfloat16()
    cb = torch.randn((20, v), generator=gen, device="cuda").bfloat16()
    before = cuda_quantizer.nearest_code.launches
    want = quantizer.nearest_code(z, cb, backend="reference")
    assert torch.equal(want, cuda_quantizer.nearest_code_reference(z, cb))
    for fn in (quantizer.nearest_code, quantizer.encode_indices):
        _ids_close(z, cb, fn(z, cb), want, 0.0)
    zq, _ = quantizer.vq_ste(z, cb)
    assert zq.shape == z.shape
    assert cuda_quantizer.nearest_code.launches == before + 3


# K14's bf16 plan edges: rows one, off a 64-row and a 128-row block;
# codes one, one short of and one past a 128-code tile; latent widths of
# one 8-column vector, a 64-column step and part of a second, and past the
# widths whose z stays resident (z rides the ring)
VQ_EDGES = [(m, k, v) for m in (1, 65, 129) for k in (1, 127, 129)
            for v in (8, 72, 1480)]


@pytest.mark.parametrize("m,k,v", VQ_EDGES)
def test_nearest_code_bf16_at_its_plan_edges(gen, m, k, v):
    """The library's bf16 plan equals the Python mirror; ids against the
    plain version's (near-ties aside), one launch a call, in range."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cuda_quantizer.vq_plan_of_library(m, v, k, sms) == \
        cuda_quantizer.vq_plan(m, v, k, sms)
    z = torch.randn((m, v), generator=gen, device="cuda").bfloat16()
    cb = torch.randn((k, v), generator=gen, device="cuda").bfloat16()
    before = cuda_quantizer.nearest_code.launches
    got = cuda_quantizer.nearest_code(z, cb)
    assert cuda_quantizer.nearest_code.launches == before + 1
    assert int(got.min()) >= 0 and int(got.max()) < k
    _ids_close(z, cb, got, cuda_quantizer.nearest_code_reference(z, cb), 1e-3)
    cb[k - 1], z[m - 1] = cb[0], cb[0]        # a tie across the last tile
    assert int(cuda_quantizer.nearest_code(z, cb)[m - 1]) == 0


# K14's fp32 plan edges: one row, rows off a 128-row block; codes off the
# 128- and 256-code tiles; widths of one vector, off a 32-column chunk and
# past z's resident widths; 2048 and 16384 rows (wide tiles, split and not)
VQ_F32_EDGES = [(m, k, v) for m in (1, 127, 129) for k in (1, 129, 257)
                for v in (4, 36, 292)] + [(2048, 8192, 256), (16384, 1000, 64),
                                          (300, 8192, 1028)]


@pytest.mark.parametrize("m,k,v", VQ_F32_EDGES)
def test_nearest_code_f32_at_its_plan_edges(gen, m, k, v):
    """The library's fp32 plan equals the Python mirror; ids equal to the
    plain version's on every row (the same fp32 products), one launch a
    call; a tie across the last tile goes to the lowest index."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = cuda_quantizer.vq_f32_plan(m, v, k, sms)
    assert cuda_quantizer.vq_f32_plan_of_library(m, v, k, sms) == plan
    z = torch.randn((m, v), generator=gen, device="cuda")
    cb = torch.randn((k, v), generator=gen, device="cuda")
    before = cuda_quantizer.nearest_code.launches
    got = cuda_quantizer.nearest_code(z, cb)
    assert cuda_quantizer.nearest_code.launches == before + 1
    _ids_close(z, cb, got, cuda_quantizer.nearest_code_reference(z, cb), 0.0)
    cb[k - 1], z[m - 1] = cb[0], cb[0]
    assert int(cuda_quantizer.nearest_code(z, cb)[m - 1]) == 0


@pytest.mark.parametrize("m,k,v", [(2048, 8192, 256), (100, 130, 32)])
def test_nearest_code_bf16_latents_fp32_codebook(gen, m, k, v):
    """A train step's operands: kernel and plain version both search the
    codebook rounded to the latents' dtype, so they compute one function."""
    z = torch.randn((m, v), generator=gen, device="cuda").bfloat16()
    cb = torch.randn((k, v), generator=gen, device="cuda")
    got = quantizer.nearest_code(z, cb)
    want = quantizer.nearest_code(z, cb, backend="reference")
    assert torch.equal(want, cuda_quantizer.nearest_code_reference(
        z, cb.bfloat16()))
    _ids_close(z, cb, got, want, 1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,v", [(100, 64, 4096), (1000, 513, 4096),
                                   (300, 130, 16384), (4096, 257, 3000 // 8 * 8),
                                   (33, 70, 16384)])
def test_nearest_code_kernel_tiles_wide_latents(gen, m, k, v, dtype):
    """z tiled over V (K14 at the vocab-4096 and -16384 widths): ids equal
    to the plain version's but for near-ties, and exact ties still go to
    the lowest index across the V tiles."""
    z = torch.randn((m, v), generator=gen, device="cuda").to(dtype)
    cb = torch.randn((k, v), generator=gen, device="cuda").to(dtype)
    before = cuda_quantizer.nearest_code.launches
    got = cuda_quantizer.nearest_code(z, cb)
    assert cuda_quantizer.nearest_code.launches == before + 1
    _ids_close(z, cb, got, cuda_quantizer.nearest_code_reference(z, cb),
               1e-3 if dtype == torch.bfloat16 else 0.0)
    cb[k - 1], z[0] = cb[3], cb[3]
    assert int(cuda_quantizer.nearest_code(z, cb)[0]) == 3


# ---------------------------------------------------------------------------
# K16 / K17: unpacked attention (the qk_norm block's)
# ---------------------------------------------------------------------------

def _qkv_views(gen, b, n, h, dh, dtype):
    """q, k, v as the qk_norm block hands them over: q and k contiguous,
    v a strided view of the packed projection output."""
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda")
    r = qkv.to(dtype).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    return r[0].contiguous(), r[1].contiguous(), r[2]


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,dh", [(2, 4, 32, 80), (3, 16, 16, 64),
                                      (2, 17, 2, 80), (2, 64, 32, 64),
                                      (2, 256, 16, 64), (1, 256, 32, 80),
                                      (3, 100, 2, 64)])
def test_flash_attention_kernels_match_plain(gen, b, n, h, dh, dtype):
    q, k, v = _qkv_views(gen, b, n, h, dh, dtype)
    do = torch.randn((b, h, n, dh), generator=gen, device="cuda").to(dtype)
    counts = (flash_attention.launches, flash_attention_fwd_lse.launches,
              flash_attention_bwd.launches)
    o_ref, lse_ref = flash_attention_reference(q, k, v)
    _close(flash_attention(q, k, v), o_ref, dtype)
    o, lse = flash_attention_fwd_lse(q, k, v)
    _close(o, o_ref, dtype)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_backward_reference(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, **TOL[dtype])
        else:
            # P and dS rounded to bf16 ahead of the last three products
            # (2^-9 relative each) against the plain version's fp32: the
            # sums of n such terms stay within 1e-2 in norm
            assert _rel(g, w) <= 1e-2
    assert (flash_attention.launches, flash_attention_fwd_lse.launches,
            flash_attention_bwd.launches) == (counts[0] + 1, counts[1] + 1,
                                              counts[2] + 1)
    assert all(torch.equal(a, c) for a, c in
               zip(got, flash_attention_bwd(q, k, v, o, lse, do)))


@pytest.mark.parametrize("n,dh", [(33, 64)] + BWD_EDGES[1:])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_autograd_and_refusals(gen, dtype, n, dh):
    q, k, v = (t.requires_grad_() for t in (
        torch.randn((2, 4, n, dh), generator=gen, device="cuda").to(dtype)
        for _ in range(3)))
    y = flash_attention(q, k, v)
    assert y.grad_fn is not None
    do = torch.randn((2, n, 4, dh), generator=gen,
                     device="cuda").to(dtype).transpose(1, 2)
    grads = torch.autograd.grad(y, (q, k, v), do)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    yr, _ = flash_attention_reference(*ref)
    want = torch.autograd.grad(yr, ref, do)
    for g, w, which in zip(grads, want, "qkv"):
        assert bool(torch.isfinite(g).all())
        if n == 1 and which != "v":
            # one key: P = 1 and dS = dP - delta, exactly 0 (so are dq and
            # dk) but for the order of the two fp32 sums on the card
            assert float(g.float().abs().max()) <= 1e-3 * float(
                grads[2].float().abs().max())
            continue
        assert _rel(g, w) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)
    bad = torch.randn((2, 4, 33, 48), device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(bad, bad, bad)
    with pytest.raises(ValueError, match="tokens"):
        big = torch.randn((1, 2, 257, 64), device="cuda", dtype=dtype)
        flash_attention(big, big, big)


@pytest.mark.parametrize("n,dim,heads", [(16, 2560, 32), (64, 1024, 16)])
def test_qk_norm_blocks_kernels_match_reference_backend(gen, n, dim, heads):
    """A qk_norm block stack in bf16 compute from fp32 parameters: forward
    and gradients through K1 / K11 (norms and q / k norms), K16 / K17,
    against backend="reference". k_norm's bias adds one vector to every key
    of a head, which moves each query's scores by a constant and leaves the
    softmax as it was: its exact gradient is zero, and both sides give
    rounding noise there, held to be small against k_norm's weight's."""
    from tae_tpu_torch.nn import vit

    cfg = vit.BlockConfig(dim, heads, qk_norm=True)
    stack = vit.blocks(cfg, 2, device="cuda")
    vit.init_weights_(stack, torch.Generator(device="cuda").manual_seed(1))
    stack.requires_grad_(True)
    x = torch.randn((4, n, dim), generator=gen, device="cuda").bfloat16()
    before = (flash_attention_fwd_lse.launches, flash_attention_bwd.launches,
              fused_layer_norm_fwd_stats.launches, fused_layer_norm_bwd.launches)
    y = vit.blocks_apply(stack, x)
    y.float().square().mean().backward()
    grads = {k: p.grad.clone() for k, p in stack.named_parameters()}
    assert (flash_attention_fwd_lse.launches - before[0],
            flash_attention_bwd.launches - before[1],
            fused_layer_norm_fwd_stats.launches - before[2],
            fused_layer_norm_bwd.launches - before[3]) == (2, 2, 8, 8)
    stack.zero_grad()
    y_ref = vit.blocks_apply(stack, x, backend="reference")
    y_ref.float().square().mean().backward()
    assert _rel(y, y_ref) <= 2e-2
    for k, p in stack.named_parameters():
        g = grads[k]
        assert bool(torch.isfinite(g).all())
        if k.endswith("attn.k_norm.bias"):
            scale = float(grads[k.replace("bias", "weight")].norm())
            assert float(g.norm()) <= 1e-2 * scale
            assert float(p.grad.norm()) <= 1e-2 * scale
        else:
            assert _rel(g, p.grad) <= 5e-2, k


# ---------------------------------------------------------------------------
# K4's int8_matmul_rows entry (q8_out, in-kernel quantize) and K15
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,block", [(1, 1024, 3072, 512), (33, 256, 768, 384),
                                         (1000, 1024, 3072, 512),
                                         (129, 2048, 6144, 512),
                                         (40, 2560, 7680, 512), (17, 48, 24, 8)])
def test_int8_matmul_q8_out_matches_plain(gen, m, k, n, block, xdtype):
    xq, sx, wq, sw, b, _ = _matmul_case(gen, m, k, n, torch.bfloat16, True,
                                        False)
    x = xq if xdtype == torch.int8 else (
        torch.randn((m, k), generator=gen, device="cuda") * 2).to(xdtype)
    if xdtype != torch.int8:
        sx = int8.row_scales(x)
    before = (int8_matmul_rows.launches, int8_matmul_fused.launches)
    yq, ys = int8_matmul_rows(x, sx, wq, sw, b, q8_block=block)
    assert (int8_matmul_rows.launches, int8_matmul_fused.launches) == (
        before[0] + 1, before[1])
    wq_, ws_ = int8_matmul_rows_reference(x, sx, wq, sw, b, q8_block=block)
    assert ys.shape == (n // block, m, 1)
    _codes_close(yq, wq_)
    _scales_close(ys, ws_)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (33, 1024, 3072), (1000, 1024, 1024),
                                   (77, 2560, 2560)])
def test_int8_matmul_in_kernel_quantize_matches_plain(gen, m, k, n, dtype):
    _, _, wq, sw, b, r = _matmul_case(gen, m, k, n, dtype, True, True)
    x = (torch.randn((m, k), generator=gen, device="cuda") * 3).to(dtype)
    sx = int8.row_scales(x)
    got = int8_matmul_rows(x, sx, wq, sw, b, r, out_dtype=dtype)
    _close(got, int8_matmul_rows_reference(x, sx, wq, sw, b, r, dtype), dtype)
    y = int8.int8_linear(x, wq, sw, b, residual=r, prequantize=False)
    assert torch.equal(y, got)
    with pytest.raises(ValueError, match="int8_matmul_fused"):
        int8_matmul_rows(_rand_i8(gen, (m, k)), sx, wq, sw, b, r,
                         out_dtype=dtype)


@pytest.mark.parametrize("b,n,h,dh,bn", [(2, 256, 16, 64, 512), (3, 129, 32, 64, 512),
                                         (2, 17, 16, 80, 640), (1, 1, 2, 64, 384),
                                         (64, 256, 16, 64, 512)])
def test_qkv_i8_attention_kernel_matches_plain(gen, b, n, h, dh, bn):
    c3 = 3 * h * dh
    qkv = _rand_i8(gen, (b, n, c3))
    scales = torch.rand((c3 // bn, b * n, 1), generator=gen,
                        device="cuda") * 0.02 + 0.001
    before = fused_qkv_attention_i8.launches
    got = fused_qkv_attention_i8(qkv, scales, h)
    assert fused_qkv_attention_i8.launches == before + 1
    _close(got, fused_qkv_attention_i8_reference(qkv, scales, h),
           torch.bfloat16)
    narrow = torch.rand((c3 // 48, b * n, 1), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="must divide"):
        fused_qkv_attention_i8(qkv, narrow, h)



# ---- the bf16 forward body (K2, K15, K16) across its 64-key chunk edges

@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("n", [63, 65, 129, 192])
def test_attention_forwards_cross_the_key_chunks(gen, n, dh):
    """Token counts just below and above the 64-key chunks (and a partial
    last chunk): K2 in its serving, exact and LSE forms, K16 in both forms
    with v a strided view, and K15, each against its plain version, one
    launch counted each."""
    h, b = 4, 3
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen,
                      device="cuda").to(torch.bfloat16)
    before = (fused_qkv_attention.launches, fused_qkv_attention_fwd_lse.launches,
              flash_attention.launches, flash_attention_fwd_lse.launches,
              fused_qkv_attention_i8.launches)
    for serving in (True, False):
        _close(fused_qkv_attention(qkv, h, serving=serving),
               fused_qkv_attention_reference(qkv, h, serving=serving),
               torch.bfloat16)
    o, lse = fused_qkv_attention_fwd_lse(qkv, h)
    o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
    _close(o, o_ref, torch.bfloat16)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    q, k, v = _qkv_views(gen, b, n, h, dh, torch.bfloat16)
    o_ref, lse_ref = flash_attention_reference(q, k, v)
    _close(flash_attention(q, k, v), o_ref, torch.bfloat16)
    o, lse = flash_attention_fwd_lse(q, k, v)
    _close(o, o_ref, torch.bfloat16)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    # K15: one scale block per q, k and v column block (bn = h * dh)
    qkv_q = _rand_i8(gen, (b, n, 3 * h * dh))
    scales = torch.rand((3, b * n, 1), generator=gen, device="cuda") * 0.02 + 0.001
    _close(fused_qkv_attention_i8(qkv_q, scales, h),
           fused_qkv_attention_i8_reference(qkv_q, scales, h), torch.bfloat16)
    assert (fused_qkv_attention.launches, fused_qkv_attention_fwd_lse.launches,
            flash_attention.launches, flash_attention_fwd_lse.launches,
            fused_qkv_attention_i8.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 1,
        before[4] + 1)


@pytest.mark.parametrize("n", [65, 129, 256])
def test_attention_exact_forms_hold_scores_far_beyond_the_clip(gen, n):
    """Scores in the hundreds, far outside the serving clip [-60, 45]:
    exp(s) alone overflows, so only the max pass keeps the exact forms
    finite. The largest score of a row lies in its last chunk for half of
    the rows, so the max must cover every chunk."""
    h, dh, b = 2, 64, 2
    qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda")
    qkv[:, :, :h * dh] *= 60.0
    qkv[:, n - 1, h * dh:2 * h * dh] *= 4.0      # a large key in the last chunk
    qkv = qkv.to(torch.bfloat16)
    exact = fused_qkv_attention(qkv, h, serving=False)
    assert torch.isfinite(exact.float()).all()
    _close(exact, fused_qkv_attention_reference(qkv, h, serving=False),
           torch.bfloat16)
    o, lse = fused_qkv_attention_fwd_lse(qkv, h)
    o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert float(lse_ref.max()) > 200.0          # exp(s) overflows fp32 past 88.7
    _close(o, o_ref, torch.bfloat16)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    r = qkv.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
    o, lse = flash_attention_fwd_lse(q, k, v)
    o_ref, lse_ref = flash_attention_reference(q, k, v)
    _close(o, o_ref, torch.bfloat16)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)

@pytest.mark.parametrize("n", [256, 64])
def test_qkv_q8_tae_kernels_match_reference_backend(gen, n):
    """A tiny int8 TAE with qkv_q8 on: from 128 tokens the blocks run K4's
    q8_out and K15 (and no int8-output attention), below it the default
    int8 route; outputs against backend="reference"."""
    from tae_tpu_torch.tokenizer import Tokenizer

    side = 16 * int(n ** 0.5)
    tok = Tokenizer.from_checkpoint(
        "tae_patch16_vocab16_px256", device="cuda", quantization="int8",
        qkv_q8=True, img_size=side, embed_dim=128, depth=2, num_heads=2,
        decoder_embed_dim=128, decoder_depth=2, decoder_num_heads=2)
    imgs = torch.randint(0, 256, (2, 3, side, side), generator=gen,
                         device="cuda", dtype=torch.uint8)
    before = (fused_qkv_attention_i8.launches, int8_matmul_rows.launches)
    z = tok.encode(imgs)
    ran = (fused_qkv_attention_i8.launches - before[0],
           int8_matmul_rows.launches - before[1])
    assert ran == ((2, 2) if n >= 128 else (0, 0))
    ref = Tokenizer(model=tok.model, policy=tok.policy, backend="reference")
    assert _rel(z, ref.encode(imgs)) <= 4e-2


# ------------------------------------ the fp32 backward and flat-row bodies

# the fp32 backward's bodies: the first design below
# F32_BWD_TILED_MIN_TOKENS (56) tokens, the register-tiled one from there;
# its key chunks (32 at dh 64, 16 at dh 80) end at 63 / 64 / 65 and 80 /
# 81, and every row tile is live from 249 / 253 tokens
F32_BWD_EDGES = [(n, dh) for dh in (64, 80)
                 for n in (1, 17, 33, 55, 56, 63, 65, 81, 129, 249, 252, 253, 256)]


@pytest.mark.parametrize("n,dh", F32_BWD_EDGES)
def test_attention_f32_backward_bodies_match_plain(gen, n, dh):
    """K10 and K17 (v a view of the packed projection) in fp32 against
    their plain versions; one launch a call, two runs bit-equal, and the
    launch the library reports equal to bwd_f32_plan's."""
    from tae_tpu_torch.ops.cuda.flash_attention import (
        F32_BWD_TILED_MIN_TOKENS, bwd_f32_plan, bwd_f32_plan_of_library)

    h = 2
    assert bwd_f32_plan_of_library(n, dh) == bwd_f32_plan(n, dh)
    assert bwd_f32_plan(n, dh).tiled == (n >= F32_BWD_TILED_MIN_TOKENS)
    qkv = torch.randn((3, n, 3 * h * dh), generator=gen, device="cuda")
    do = torch.randn((3, n, h * dh), generator=gen, device="cuda")
    o, lse = fused_qkv_attention_fwd_lse(qkv, h)
    before = fused_qkv_attention_bwd.launches
    got = fused_qkv_attention_bwd(qkv, o, lse, do, h)
    assert fused_qkv_attention_bwd.launches == before + 1
    _close(got, fused_qkv_attention_backward_reference(qkv, o, lse, do, h),
           torch.float32)
    assert torch.equal(got, fused_qkv_attention_bwd(qkv, o, lse, do, h))
    r = qkv.view(3, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
    o, lse = flash_attention_fwd_lse(q, k, v)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    got = flash_attention_bwd(q, k, v, o, lse, dout)
    want = flash_attention_backward_reference(q, k, v, o, lse, dout)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)
    assert all(torch.equal(a, b) for a, b in
               zip(got, flash_attention_bwd(q, k, v, o, lse, dout)))


@pytest.mark.parametrize("b,n,h,dh", [(7, 1, 3, 64), (7, 3, 17, 80), (5, 5, 3, 64),
                                      (9, 8, 17, 64), (3, 12, 2, 80), (5, 16, 48, 64),
                                      (3, 24, 3, 80), (2, 33, 3, 64), (3, 63, 5, 80),
                                      (2, 64, 32, 64), (64, 4, 32, 80)])
def test_rows_body_f32_matches_plain_and_its_plan(gen, b, n, h, dh):
    """The flat-row body's fp32 form: K6 in both softmax forms and K9
    against their plain versions where its tiles, windows (one an image past
    64 keys a tile) and head groups end; its plan equal to the library's;
    K8 equal to K9 on the same bytes bit for bit at every token count (the
    tiled forward body from 33 tokens keeps the same sums)."""
    from tae_tpu_torch.ops.cuda.wide_attention import rows_plan_f32

    qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda")
    for q8 in (True, False):
        plan, units = rows_plan_of_library(n, h, dh, q8, torch.float32)
        assert plan == rows_plan_f32(n, h, dh, q8) and units > 0
    for serving in (True, False):
        _close(fused_qkv_attention_wide(qkv, h, serving=serving),
               fused_qkv_attention_wide_reference(qkv, h, serving=serving),
               torch.float32)
    flat = qkv.reshape(b * n, -1)
    q9, s9 = fused_qkv_attention_wide_q8_2d(flat, n, h)
    q_ref, s_ref = fused_qkv_attention_wide_q8_2d_reference(flat, n, h)
    assert (q9.int() - q_ref.int()).abs().max() <= 1
    torch.testing.assert_close(s9, s_ref, atol=0, rtol=1e-5)
    q8_, s8 = fused_qkv_attention_wide_q8(qkv, h)
    assert torch.equal(q8_.reshape(b * n, -1), q9) and torch.equal(s8.reshape(b * n, 1), s9)


@pytest.mark.parametrize("b,n,h,dh", [(3, 32, 16, 64), (3, 33, 16, 64), (2, 65, 3, 80),
                                      (2, 255, 5, 80), (1, 256, 17, 64), (2, 40, 48, 80)])
def test_q8_f32_tiled_body_matches_plain_and_its_plan(gen, b, n, h, dh):
    """K7 in fp32 either side of the rule, at a part-filled 64-row tile,
    head counts whose last rank takes fewer heads (17, 5) and 3 heads a
    block (48); its plan equal to the library's from 33 tokens; codes within
    one step and scales to 1e-5 of the plain version; two runs bit-equal."""
    from tae_tpu_torch.ops.cuda.wide_attention import q8_f32_plan

    qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda")
    plan, clusters = q8_plan_of_library(n, h, dh, torch.float32)
    assert plan == q8_f32_plan(n, h, dh)
    assert (plan is None) == (n < F32_TILED_MIN_TOKENS)
    assert plan is None or clusters > 0
    q, s = fused_qkv_attention_q8(qkv, h)
    q_ref, s_ref = fused_qkv_attention_q8_reference(qkv, h)
    assert (q.int() - q_ref.int()).abs().max() <= 1
    torch.testing.assert_close(s, s_ref, atol=0, rtol=1e-5)
    again = fused_qkv_attention_q8(qkv, h)
    assert torch.equal(q, again[0]) and torch.equal(s, again[1])


# ------------------------------------------------- host pipeline, calibration

def test_device_prefetch_keeps_order_and_overlaps(gen):
    """Batches come back in order, on the card, equal to the host data; the
    copies run on a side stream while the current stream is busy with the
    steps, so steps that keep the card busy for S each take about n·S in
    all, not n·S plus the copies. (The host batches are pinned already, so
    pinning costs nothing; nothing in the loop waits on the card, as in a
    driver, so the host queues ahead.)"""
    import time

    from tae_tpu_torch.data.loader import device_prefetch

    n, elems = 8, 64 << 20                          # 256 MB of fp32 a batch
    host = [torch.full((elems,), float(i)).pin_memory() for i in range(n)]
    cycles = int(torch.cuda.get_device_properties(0).clock_rate * 1e3 * 0.04)

    def run(step_cycles: int, data: bool = True) -> float:
        marks = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        if not data:
            for _ in range(n):
                torch.cuda._sleep(step_cycles)
        else:
            for x in device_prefetch(iter(host), "cuda"):
                assert x.is_cuda and x.dtype == torch.float32
                marks.append(torch.stack([x[0], x[-1]]))
                torch.cuda._sleep(step_cycles)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if data:                                    # in order, whole
            assert torch.stack(marks).tolist() == [[float(i)] * 2
                                                   for i in range(n)]
        return dt

    run(0)                                          # warm up
    copies = run(0)
    steps = run(cycles, data=False)
    both = run(cycles)
    # serial copies would add all of `copies`; overlapped, about one of them
    assert both < steps + 0.5 * copies, (both, steps, copies)


def test_ln_amax_on_the_card_equals_its_reference_run(gen):
    """The calibration pass through K1 and K2 in fp32 (exact softmax) equals
    the plain versions' run to fp32 rounding, channel by channel, and
    launches K1 and K2 only."""
    from tae_tpu_torch.calibrate import ln_amax
    from tae_tpu_torch.ops.cuda.flash_attention import fused_qkv_attention
    from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm

    cfg = TAEConfig(img_size=64, embed_dim=256, depth=2, num_heads=4,
                    decoder_embed_dim=256, decoder_depth=2, decoder_num_heads=4)
    model = TAE(cfg, device="cuda").init_weights_(gen).to(torch.bfloat16)
    batches = [torch.randint(0, 256, (8, 3, 64, 64), dtype=torch.uint8,
                             device="cuda", generator=gen) for _ in range(2)]
    ln0, at0 = fused_layer_norm.launches, fused_qkv_attention.launches
    got = ln_amax(model, batches)
    assert fused_layer_norm.launches - ln0 == 2 * (2 * 2 * 2 + 2)
    assert fused_qkv_attention.launches - at0 == 2 * 4
    want = ln_amax(model, batches, backend="reference")
    assert got.keys() == want.keys()
    for k in want:
        err = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        assert err <= 1e-4, (k, err)


# ------------------------------------------- the downstream trunks' shapes:
# width 768 (K1, its stats form, K11) and 12 heads of 64 (K2, K10)

@pytest.mark.parametrize("rows", [16384, 2048, 33])
def test_layer_norm_kernels_at_the_downstream_width(gen, rows):
    """K1, its stats form and K11 at width 768 (three groups of 256): the
    plans equal the library's, each against its plain version, K11's two
    runs bit-equal, y of both K1 entries the same."""
    d, dtype = 768, torch.bfloat16
    assert fwd_plan_of_library(rows, d) == fwd_plan(rows, d)
    assert bwd_plan_of_library(rows, d) == bwd_plan(rows, d)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3 + 1).to(dtype)
    w = (torch.randn(d, generator=gen, device="cuda") + 1).to(dtype)
    b = torch.randn(d, generator=gen, device="cuda").to(dtype)
    dy = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    y = fused_layer_norm(x, w, b, 1e-6)
    _close(y, layer_norm_reference(x, w, b, 1e-6), dtype)
    y2, mean, rstd = fused_layer_norm_fwd_stats(x, w, b, 1e-6)
    _, mean_ref, rstd_ref = layer_norm_stats_reference(x, w, b, 1e-6)
    assert torch.equal(y, y2)
    torch.testing.assert_close(mean, mean_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, atol=1e-5, rtol=1e-5)
    dx, dw, db = fused_layer_norm_bwd(x, w, mean, rstd, dy)
    dx_ref, dw_ref, db_ref = layer_norm_backward_reference(x, w, mean, rstd, dy)
    _close(dx, dx_ref, dtype)
    tol = dict(atol=1e-2 * max(1.0, rows ** 0.5 / 8), rtol=1e-2)
    torch.testing.assert_close(dw.float(), dw_ref.float(), **tol)
    torch.testing.assert_close(db.float(), db_ref.float(), **tol)
    again = fused_layer_norm_bwd(x, w, mean, rstd, dy)
    assert all(torch.equal(a, c) for a, c in zip(again, (dx, dw, db)))


def test_layer_norm_kernel_refuses_a_view(gen):
    """K1 takes contiguous rows only: a strided view of a residual stream
    raises (where the JAX LayerNorm takes it); its contiguous copy runs."""
    x = torch.randn((4, 32, 768), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(768, device="cuda", dtype=torch.bfloat16)
    view = x[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_layer_norm(view, w, b)
    _close(fused_layer_norm(view.contiguous(), w, b),
           layer_norm_reference(view, w, b), torch.bfloat16)


@pytest.mark.parametrize("b,n", [(64, 256), (3, 129), (2, 17)])
def test_twelve_head_attention_kernels_match_plain(gen, b, n):
    """K2 (serving, exact, LSE) and K10 at 12 heads of 64, the downstream
    trunks' attention; K10's two runs bit-equal."""
    h, dh, dtype = 12, 64, torch.bfloat16
    c = h * dh
    qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, n, c), generator=gen, device="cuda").to(dtype)
    for serving in (True, False):
        _close(fused_qkv_attention(qkv, h, serving=serving),
               fused_qkv_attention_reference(qkv, h, serving=serving), dtype)
    o, lse = fused_qkv_attention_fwd_lse(qkv, h)
    o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
    _close(o, o_ref, dtype)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    dqkv = fused_qkv_attention_bwd(qkv, o, lse, do, h)
    _close(dqkv, fused_qkv_attention_backward_reference(qkv, o, lse, do, h),
           dtype)
    assert torch.equal(dqkv, fused_qkv_attention_bwd(qkv, o, lse, do, h))


@pytest.mark.parametrize("kind", ["recognition", "segmentation"])
def test_downstream_trunk_step_kernels_match_reference_backend(gen, kind):
    """One train step's forward and backward of a small downstream trunk
    (12 heads of 64, 256 tokens, the segmenter's auxiliary tap after 3 of 4
    blocks) through the kernels against backend="reference": the training
    entries' launches, the loss and every gradient."""
    from tae_tpu_torch import models
    from tae_tpu_torch.cli.train_segmentation import criterion
    from tae_tpu_torch.train.losses import cross_entropy

    kw = dict(vocab_size=16, decoder_embed_dim=768, decoder_depth=4,
              decoder_num_heads=12)
    if kind == "recognition":
        name, kw = "vit_recognition_numpatches256_vocab16_base", dict(
            kw, num_classes=10)
        target = torch.arange(4, device="cuda")
        loss_of = cross_entropy
    else:
        name, kw = "vit_segmentation_numpatches256_vocab16_base", dict(
            kw, num_classes=5, patch_size=4)
        target = torch.randint(0, 5, (4, 64, 64), generator=gen, device="cuda")
        target[:, :8] = 255
        loss_of = criterion
    z = torch.randn((4, 256, 16), generator=gen, device="cuda")
    grads, losses = [], []
    for backend in (None, "reference"):
        model = models.create(name, device="cuda", trainable=True, **kw)
        model.init_weights_(torch.Generator(device="cuda").manual_seed(3))
        counts = (fused_layer_norm_fwd_stats.launches,
                  fused_layer_norm_bwd.launches,
                  fused_qkv_attention_fwd_lse.launches,
                  fused_qkv_attention_bwd.launches)
        loss = loss_of(model(z, policy=Policy(), backend=backend), target)
        loss.backward()
        torch.cuda.synchronize()
        norms = 2 * 4 + 1 + (kind == "segmentation")
        want = (norms, norms, 4, 4) if backend is None else (0, 0, 0, 0)
        assert tuple(a - b for a, b in zip(
            (fused_layer_norm_fwd_stats.launches, fused_layer_norm_bwd.launches,
             fused_qkv_attention_fwd_lse.launches,
             fused_qkv_attention_bwd.launches), counts)) == want
        losses.append(float(loss.detach()))
        grads.append([p.grad.float() for p in model.parameters()])
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1])
    for a, b in zip(*grads):
        assert float((a - b).norm() / b.norm().clamp_min(1e-20)) <= 2.5e-2
