"""The port's tiny-N and int8-output attention entries vs the JAX package, on
the CPU: ``fused_qkv_attention_wide``, ``fused_qkv_attention_q8``,
``fused_qkv_attention_wide_q8`` and ``fused_qkv_attention_wide_q8_2d``, and
the dispatch rule that picks between them.

Inputs are made with numpy from a seed and fed to both packages. The JAX
Pallas kernels run in interpret mode, as tests/test_ops.py runs them; the
port runs its plain versions (the kernel wrappers take them for CPU
tensors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.pallas import flash_attention as jfa
from tae_tpu_torch.ops import attention as tattn
from tae_tpu_torch.ops.cuda import flash_attention as tfa
from tae_tpu_torch.ops.cuda import wide_attention as twa
from tae_tpu_torch.ops.int8 import quantize_rows

# Float outputs. fp32: both sides sum the scores and the P.V product in fp32
# in their own order (the bound tests/test_torch_ops.py holds the per-image
# kernel to). bf16: both compute in fp32 and round once; a last-bit
# difference can flip that rounding: one bf16 ulp.
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
# int8 outputs. Both sides round the same fp32 o * (1 / s) to codes; o can
# differ in its last bits (summation order), so a value within that of a
# rounding tie lands on the neighbouring code: one step on at most 1e-3 of
# the elements. Scales are amax / 127: rtol 1e-6, because interpret mode
# runs under jit, where XLA turns the division into a product with 1/127
# (one ulp). In bf16 the P.V product takes p rounded to bf16 and a p whose
# fp32 value differs in its last bits can round to the neighbouring bf16
# value, which moves one head's outputs of one row by up to 2^-7 of that
# probability's share: on those rows (at most 1% of them) the scale may
# move by up to 2e-2 (the tolerance the card checks hold kernel and plain
# version to; at these sizes on the CPU no row went beyond 6.1e-7).
CODE_FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-6
BF16_SCALE_SHARE, BF16_SCALE_RTOL = 1e-2, 2e-2

# (tokens, heads, head dim): the tiny-N configs' token counts at both head
# dims, and a count (8) where two images share a 16-row tile
WIDE_SHAPES = [(4, 4, 80), (16, 4, 80), (64, 4, 64), (8, 2, 64)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _qkv(b, n, h, dh, dtype, seed=7):
    """The same packed qkv for both packages, already rounded to ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(
        (b, n, 3 * h * dh)).astype(np.float32)
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _codes_and_scales_close(got, want, dtype):
    (q, s), (jq, js) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == tuple(jq.shape) and tuple(s.shape) == tuple(js.shape)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= CODE_FLIP_SHARE, (diff > 0).mean()
    rel = np.abs(s.numpy() - np.asarray(js)) / np.asarray(js)
    if dtype == "float32":
        assert rel.max() <= SCALE_RTOL, rel.max()
    else:
        assert rel.max() <= BF16_SCALE_RTOL, rel.max()
        assert (rel > SCALE_RTOL).sum() <= max(1, BF16_SCALE_SHARE * rel.size)


# ------------------------------------------------------------ K6: wide, float

@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,dh", WIDE_SHAPES)
def test_wide_attention_matches_jax(n, h, dh, dtype, serving):
    jqkv, tqkv = _qkv(6, n, h, dh, dtype)
    want = jfa.fused_qkv_attention_wide(jqkv, h, None, None, True, serving)
    got = twa.fused_qkv_attention_wide(tqkv, h, serving=serving)
    assert got.dtype == tqkv.dtype and tuple(got.shape) == (6, n, h * dh)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    # the wrapper took the plain version, and the explicit scale is the default
    assert torch.equal(got, twa.fused_qkv_attention_wide_reference(
        tqkv, h, dh ** -0.5, serving))
    assert twa.fused_qkv_attention_wide.launches == 0


@pytest.mark.parametrize("n,h,dh", WIDE_SHAPES)
def test_wide_attention_equals_the_per_image_entry(n, h, dh):
    """Several images per tile under the 0/1 mask is the per-image
    computation: on the CPU both entries run the same plain arithmetic."""
    _, tqkv = _qkv(5, n, h, dh, "float32", seed=11)
    for serving in (True, False):
        assert torch.equal(
            twa.fused_qkv_attention_wide(tqkv, h, serving=serving),
            tfa.fused_qkv_attention(tqkv, h, serving=serving))


# ------------------------------------------------- K7-K9: int8-output entries

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,dh", [(128, 4, 64), (16, 4, 80)])
def test_attention_q8_matches_jax(n, h, dh, dtype):
    jqkv, tqkv = _qkv(3, n, h, dh, dtype)
    want = jfa.fused_qkv_attention_q8(jqkv, h, interpret=True)
    got = twa.fused_qkv_attention_q8(tqkv, h)
    assert tuple(got[0].shape) == (3, n, h * dh)
    assert tuple(got[1].shape) == (3, n, 1)
    _codes_and_scales_close(got, want, dtype)
    assert twa.fused_qkv_attention_q8.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,dh", WIDE_SHAPES)
def test_wide_attention_q8_matches_jax(n, h, dh, dtype):
    jqkv, tqkv = _qkv(8, n, h, dh, dtype)
    want = jfa.fused_qkv_attention_wide_q8(jqkv, h, interpret=True)
    got = twa.fused_qkv_attention_wide_q8(tqkv, h)
    _codes_and_scales_close(got, want, dtype)
    assert twa.fused_qkv_attention_wide_q8.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,dh", WIDE_SHAPES)
def test_wide_attention_q8_2d_matches_jax_and_equals_3d(n, h, dh, dtype):
    b = 8
    jqkv, tqkv = _qkv(b, n, h, dh, dtype)
    want = jfa.fused_qkv_attention_wide_q8_2d(jqkv.reshape(b * n, -1), n, h,
                                              interpret=True)
    got = twa.fused_qkv_attention_wide_q8_2d(tqkv.reshape(b * n, -1), n, h)
    assert tuple(got[0].shape) == (b * n, h * dh)
    assert tuple(got[1].shape) == (b * n, 1)
    _codes_and_scales_close(got, want, dtype)
    # bit-identical to the 3D entry, as the JAX pair is
    q3, s3 = twa.fused_qkv_attention_wide_q8(tqkv, h)
    assert torch.equal(got[0], q3.reshape(b * n, -1))
    assert torch.equal(got[1], s3.reshape(b * n, 1))
    assert twa.fused_qkv_attention_wide_q8_2d.launches == 0


@pytest.mark.parametrize("n,h,dh", [(4, 4, 80), (16, 2, 64)])
def test_q8_output_is_the_quantized_fp32_output(n, h, dh):
    """The codes come from the fp32 attention output with an exact
    reciprocal; dequantized they sit within half a step of it. In bf16 a
    separate ``quantize_rows`` of the rounded output gives other codes:
    the two routes are different functions."""
    _, tqkv = _qkv(4, n, h, dh, "bfloat16", seed=3)
    o = tfa.packed_attention_f32(tqkv, h, serving=True)
    q, s = twa.fused_qkv_attention_wide_q8(tqkv, h)
    assert torch.equal(s, (o.abs().amax(-1, keepdim=True) / 127.0))
    assert torch.equal(q, torch.round(o * (1.0 / s)).to(torch.int8))
    assert float((q.float() * s - o).abs().max()) <= 0.5 * float(s.max()) * 1.001
    assert int(q.abs().max()) == 127
    q_two_pass, _ = quantize_rows(tfa.fused_qkv_attention(tqkv, h, serving=True))
    assert not torch.equal(q, q_two_pass)
    # a row of zeros quantizes to zeros with the floor scale
    zq, zs = twa.quantize_attention_rows(torch.zeros(2, 8))
    assert int(zq.abs().max()) == 0 and float(zs.max()) == pytest.approx(1e-12)


# --------------------------------------------------- batches, clamp, refusals

@pytest.mark.parametrize("b", [1, 3, 7, 13])
def test_a_batch_that_fills_no_block_matches_jax(b):
    """Batches that are a multiple of no block size (the JAX wrappers halve
    their block until it divides; the port's kernels mask a ragged tile)."""
    n, h, dh = 4, 2, 64
    jqkv, tqkv = _qkv(b, n, h, dh, "float32", seed=b)
    want = jfa.fused_qkv_attention_wide(jqkv, h, None, None, True, True)
    np.testing.assert_allclose(
        _np(twa.fused_qkv_attention_wide(tqkv, h)), _np(want), **TOL["float32"])
    _codes_and_scales_close(
        twa.fused_qkv_attention_wide_q8(tqkv, h),
        jfa.fused_qkv_attention_wide_q8(jqkv, h, interpret=True), "float32")
    _codes_and_scales_close(
        twa.fused_qkv_attention_wide_q8_2d(tqkv.reshape(b * n, -1), n, h),
        jfa.fused_qkv_attention_wide_q8_2d(jqkv.reshape(b * n, -1), n, h,
                                           interpret=True), "float32")


def _underflow_qkv():
    """Every score far below the exp's underflow (the input of
    tests/test_ops.py::test_serving_softmax_total_on_underflowing_scores)."""
    n, h, dh = 4, 2, 64
    c = h * dh
    qkv = np.zeros((2, n, 3 * c), np.float32)
    qkv[:, :, :c] = 40.0          # q rows aligned
    qkv[:, :, c:2 * c] = -40.0    # k rows anti-aligned
    qkv[:, :, 2 * c:] = np.random.default_rng(0).standard_normal((2, n, c))
    return qkv, n, h


@pytest.mark.parametrize("serving", [True, False])
def test_underflowing_scores_stay_finite_and_equal_jax(serving):
    qkv, n, h = _underflow_qkv()
    want = jfa.fused_qkv_attention_wide(jnp.asarray(qkv), h, None, None, True,
                                        serving)
    got = twa.fused_qkv_attention_wide(torch.from_numpy(qkv), h,
                                       serving=serving)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    # uniform attention: every row is the mean of its image's v rows
    c = qkv.shape[-1] // 3
    mean_v = qkv[:, :, 2 * c:].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(_np(got), np.broadcast_to(mean_v, got.shape),
                               atol=2e-5)


def test_underflowing_scores_int8_entries_equal_jax():
    qkv, n, h = _underflow_qkv()
    j, t = jnp.asarray(qkv), torch.from_numpy(qkv)
    b = qkv.shape[0]
    got = twa.fused_qkv_attention_wide_q8(t, h)
    assert torch.isfinite(got[1]).all()
    _codes_and_scales_close(
        got, jfa.fused_qkv_attention_wide_q8(j, h, interpret=True), "float32")
    _codes_and_scales_close(
        twa.fused_qkv_attention_wide_q8_2d(t.reshape(b * n, -1), n, h),
        jfa.fused_qkv_attention_wide_q8_2d(j.reshape(b * n, -1), n, h,
                                           interpret=True), "float32")
    _codes_and_scales_close(
        twa.fused_qkv_attention_q8(t, h),
        jfa.fused_qkv_attention_q8(j, h, interpret=True), "float32")


def test_wide_entries_refuse_more_than_64_tokens():
    x = torch.zeros(1, 65, 3 * 128)
    for fn in (twa.fused_qkv_attention_wide, twa.fused_qkv_attention_wide_q8):
        with pytest.raises(ValueError, match="1..64 tokens"):
            fn(x, 2)
    with pytest.raises(ValueError, match="1..64 tokens"):
        twa.fused_qkv_attention_wide_q8_2d(x.reshape(65, -1), 65, 2)
    with pytest.raises(ValueError, match="rows"):
        twa.fused_qkv_attention_wide_q8_2d(torch.zeros(10, 3 * 128), 4, 2)
    with pytest.raises(ValueError, match="does not split"):
        twa.fused_qkv_attention_wide(torch.zeros(1, 4, 100), 2)
    # the per-image int8 entry has no such limit on the CPU
    q, s = twa.fused_qkv_attention_q8(x, 2)
    assert tuple(q.shape) == (1, 65, 128) and tuple(s.shape) == (1, 65, 1)


@pytest.mark.parametrize("name", ["fused_qkv_attention_wide",
                                  "fused_qkv_attention_q8",
                                  "fused_qkv_attention_wide_q8",
                                  "fused_qkv_attention_wide_q8_2d"])
def test_wrappers_never_fall_back_off_the_cpu(name):
    """A tensor that is neither on the CPU nor on a CUDA device raises: the
    plain version is taken for CPU tensors only."""
    fn = getattr(twa, name)
    x = torch.zeros((2, 4, 3 * 128), device="meta")
    args = (x.reshape(8, -1), 4, 2) if name.endswith("_2d") else (x, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fn(*args)
    assert fn.launches == 0


# -------------------------------------------------------------- dispatch rule

# (tokens, int8 block, serving, attn_q8) -> (route, int8 output)
ROUTE_TABLE = [
    # float blocks: the wide entry while several images share a 16-row tile
    ((4, False, True, None), ("wide", False)),
    ((4, False, False, None), ("wide", False)),
    ((8, False, True, None), ("wide", False)),
    ((16, False, True, None), ("packed", False)),
    ((64, False, False, None), ("packed", False)),
    ((256, False, True, None), ("packed", False)),
    ((4, False, True, True), ("wide", False)),       # attn_q8: int8 blocks only
    # serving int8 blocks: int8 output at every token count
    ((1, True, True, None), ("wide_q8_2d", True)),
    ((4, True, True, None), ("wide_q8_2d", True)),
    ((8, True, True, None), ("wide_q8", True)),
    ((16, True, True, None), ("wide_q8", True)),
    ((64, True, True, None), ("wide_q8", True)),
    ((65, True, True, None), ("packed_q8", True)),
    ((256, True, True, None), ("packed_q8", True)),
    ((256, True, True, True), ("packed_q8", True)),
    # ... unless asked otherwise, or outside serving (exact softmax)
    ((4, True, True, False), ("wide", False)),
    ((16, True, True, False), ("packed", False)),
    ((256, True, True, False), ("packed", False)),
    ((4, True, False, None), ("wide", False)),
    ((16, True, False, True), ("packed", False)),
    ((256, True, False, None), ("packed", False)),
]


@pytest.mark.parametrize("args,want", ROUTE_TABLE)
def test_attention_route_table(args, want):
    assert tattn.attention_route(*args) == want
    assert want[0] in tattn.ROUTES


@pytest.mark.parametrize("route", sorted(tattn.ROUTES))
def test_packed_attention_runs_every_route(route):
    """``packed_attention`` hands each route its layout: float routes give
    (B, N, C), int8 routes flat rows, and backend="reference" is the same
    function on the CPU."""
    b, n, h, dh = 3, 4, 2, 64
    _, tqkv = _qkv(b, n, h, dh, "float32", seed=2)
    got = tattn.packed_attention(tqkv, h, route, serving=True)
    ref = tattn.packed_attention(tqkv, h, route, serving=True,
                                 backend="reference")
    o = tfa.packed_attention_f32(tqkv, h, serving=True)
    if route in ("packed", "wide"):
        assert torch.equal(got, o) and torch.equal(ref, o)
        exact = tattn.packed_attention(tqkv, h, route, serving=False)
        assert torch.equal(exact,
                           tfa.packed_attention_f32(tqkv, h, serving=False))
        return
    q, s = twa.quantize_attention_rows(o.reshape(b * n, -1))
    for out in (got, ref):
        assert torch.equal(out[0], q) and torch.equal(out[1], s)
    with pytest.raises(ValueError, match="serving softmax only"):
        tattn.packed_attention(tqkv, h, route, serving=False)
