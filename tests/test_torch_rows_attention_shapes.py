"""The flat-row attention body (K6 ``fused_qkv_attention_wide``, K9
``fused_qkv_attention_wide_q8_2d``, and K8 ``fused_qkv_attention_wide_q8``
below 16 tokens) at the edges of its plan, on the CPU: the launch plan the
CUDA entries follow (``rows_plan``, mirrored from
``csrc/rows_attention.cuh``), and the port's plain versions against
``tae_tpu.ops.pallas.flash_attention`` in interpret mode at the shapes where
that plan's tiles, chunks and head groups end.

On the card a block takes 16 consecutive flat rows and a group of heads, a
warp each (4 heads a block, more where 16 blocks of 4 do not cover an int8
row's heads), the blocks of one row tile in a thread-block cluster when the
output is int8, and stages the keys its rows can see in chunks of up to 64.
The shapes here sit on those edges: tokens 1, 3, 4, 5, 8, 12 and 16 (16 / n
whole images a tile, or images that straddle tiles), 1, 3, 17, 32, 48 and
80 heads at head dims 64 and 80, row counts that leave the last tile
part-filled and head counts that leave the last group a head short.
tests/test_torch_cuda.py holds the kernels to these plain versions.

Tolerances (as tests/test_torch_wide_attention.py): float outputs fp32
atol 2e-5 / rtol 1e-4 (both sides sum in fp32 in their own order), bf16
atol = rtol = 1e-2 (one bf16 rounding of a value that may differ in its last
fp32 bits). int8 outputs: codes may differ by one step on at most 1e-3 of
the elements (o can differ in its last bits, moving a value across a
rounding tie); scales rtol 1e-6 in fp32 (interpret mode runs under jit,
where XLA turns the division by 127 into a product, one ulp); in bf16 the
P.V product takes p rounded to bf16, so a p whose fp32 value differs in its
last bits can round to the neighbouring bf16 value: on at most 1% of the
rows the scale may move by up to 2e-2.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.pallas import flash_attention as jfa
from tae_tpu_torch.ops import attention as tattn
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda import wide_attention as twa

TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
CODE_FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-6
BF16_SCALE_SHARE, BF16_SCALE_RTOL = 1e-2, 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _smem(n, h, dh, q8):
    """Shared memory the plan should ask for, counted here from scratch:
    per warp the 16-row Q tile and a chunk of K and V in bf16 rows of dh +
    8, and with the int8 output one fp32 max per warp and row and one per
    row for the block."""
    hpb = twa.rows_plan(n, h, dh, q8).heads_per_block
    chunk = twa.rows_chunk(n)
    return hpb * (16 + 2 * chunk) * (dh + 8) * 2 + ((hpb + 1) * 16 * 4 if q8 else 0)


# ------------------------------------------------------------ the plan

# (tokens, heads, head dim, int8 output) -> (cluster, head groups, heads a
# block, keys a chunk, shared bytes): p128 (K9, K6), K6 at 8 tokens, a small
# int8 block at 8 tokens, and 80 heads (5 a block: 16 blocks of 4 are short)
PLANS = [
    ((4, 32, 80, True), (8, 8, 4, 16, 4 * 48 * 88 * 2 + 5 * 16 * 4)),
    ((4, 32, 80, False), (1, 8, 4, 16, 4 * 48 * 88 * 2)),
    ((8, 32, 80, False), (1, 8, 4, 16, 4 * 48 * 88 * 2)),
    ((8, 2, 64, True), (1, 1, 2, 16, 2 * 48 * 72 * 2 + 3 * 16 * 4)),
    ((16, 80, 64, True), (16, 16, 5, 16, 5 * 48 * 72 * 2 + 6 * 16 * 4)),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_rows_plan_at_the_registered_shapes(shape, want):
    assert twa.rows_plan(*shape) == twa.RowsPlan(*want)


@pytest.mark.parametrize("rows,blocks", [(256, 128), (32, 16), (4, 8)])
def test_rows_plan_fills_the_card_at_p128(rows, blocks):
    """p128 at B = 64, 8, 1: 16 / 2 / 1 row tiles of 16 rows, each over 8
    head groups of 4 heads (the parent's design ran 16 / 2 / 1 blocks); K9's
    8 groups form one cluster a tile."""
    for q8 in (True, False):
        plan = twa.rows_plan(4, 32, 80, q8)
        assert -(-rows // twa.ROWS_TILE) * plan.groups == blocks
        assert plan.cluster == (8 if q8 else 1)


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("h", [1, 3, 17, 32, 48, 80])
def test_rows_plan_at_its_head_count_edges(h, dh):
    """heads a block = min(H, 4), raised to ceil(H / 16) with the int8
    output; the last group takes the rest (17 heads: 5 groups, the last with
    one); with the int8 output every group of a row tile is one cluster; at
    every token count of the tiny-N edges the chunk is rows_chunk's."""
    for n in (1, 3, 4, 5, 8, 12, 16):
        for q8 in (True, False):
            plan = twa.rows_plan(n, h, dh, q8)
            hpb = max(min(h, 4), -(-h // 16)) if q8 else min(h, 4)
            assert plan.heads_per_block == hpb
            assert plan.groups == -(-h // hpb)
            assert 1 <= h - (plan.groups - 1) * hpb <= hpb
            assert plan.cluster == (plan.groups if q8 else 1) <= (16 if q8 else 65535)
            assert plan.chunk == twa.rows_chunk(n) == (16 if 16 % n == 0 else
                                                       32 if n < 8 else 48)
            assert plan.smem == _smem(n, h, dh, q8) <= twa.SMEM_LIMIT


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 12, 16, 24, 40, 63, 64, 65, 256])
def test_rows_chunk_holds_the_widest_key_range_of_a_tile(n):
    """The keys a 16-row tile can see are its images' (from the first row's
    image to the last row's): the chunk holds all of them in one piece
    where they fit in 64, else 64 keys a chunk; always a multiple of 16."""
    widest = 0
    for r0 in range(0, 16 * n * 3, 16):
        lo, hi = r0 // n * n, ((r0 + 15) // n + 1) * n
        widest = max(widest, hi - lo)
    chunk = twa.rows_chunk(n)
    assert chunk % 16 == 0 and chunk <= twa.ROWS_MAX_CHUNK
    assert chunk >= min(-(-widest // 16) * 16, twa.ROWS_MAX_CHUNK)


def test_rows_plan_covers_every_head_count_once():
    """Every head in exactly one group; the int8 form in one cluster of at
    most 16 blocks up to 128 heads, none above; the bf16 form at any count."""
    for h in range(1, 141):
        for q8 in (True, False):
            plan = twa.rows_plan(64, h, 64, q8)
            if q8 and h > twa.ROWS_Q8_MAX_HEADS:
                assert plan is None
                continue
            hpb = plan.heads_per_block
            assert (plan.groups - 1) * hpb < h <= plan.groups * hpb
            assert hpb <= twa.ROWS_MAX_HEADS_PER_BLOCK
            if q8:
                assert plan.cluster == plan.groups <= twa.ROWS_MAX_CLUSTER
            assert plan.smem <= twa.SMEM_LIMIT


@pytest.mark.parametrize("args", [(0, 4, 64, True), (257, 4, 64, False),
                                  (4, 4, 96, True), (4, 129, 64, True)])
def test_rows_plan_refuses_what_the_body_does_not_take(args):
    """no tokens, more than 256, another head dim, more int8 heads than 16
    blocks of 8 hold."""
    assert twa.rows_plan(*args) is None


def test_rows_plan_mirrors_the_kernel_header():
    text = (build.CSRC_DIR / "rows_attention.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kTile") == twa.ROWS_TILE
    assert const("kHeadsPerBlock") == twa.ROWS_HEADS_PER_BLOCK
    assert const("kMaxCluster") == twa.ROWS_MAX_CLUSTER
    assert const("kMaxHeadsPerBlock") == twa.ROWS_MAX_HEADS_PER_BLOCK
    assert const("kMaxChunk") == twa.ROWS_MAX_CHUNK
    assert const("kMaxTokens") == twa.MAX_TOKENS
    assert "tae_rows_attention_plan" in build.SIGNATURES
    assert pathlib.Path(build.CSRC_DIR / "wide_attention.cu").is_file()


# ------------------------------------------- the plain versions against JAX

def _qkv(b, n, h, dh, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, n, 3 * h * dh)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


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


# (batch, tokens, heads, head dim): rows 21, 25, 36, 7, 72 and 20 leave the
# last 16-row tile part-filled; 3 and 17 heads leave the last group a head
# short; 5 and 12 tokens put images across tile boundaries, 12 staging a
# 48-key chunk
EDGE_SHAPES = [(7, 3, 17, 80), (5, 5, 3, 64), (3, 12, 3, 80), (7, 1, 1, 64),
               (9, 8, 2, 80), (5, 4, 32, 80)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,dh", EDGE_SHAPES)
def test_k9_plain_version_matches_jax_at_the_plan_edges(b, n, h, dh, dtype):
    jqkv, tqkv = _qkv(b, n, h, dh, dtype, seed=31)
    want = jfa.fused_qkv_attention_wide_q8_2d(jqkv.reshape(b * n, -1), n, h,
                                              interpret=True)
    got = twa.fused_qkv_attention_wide_q8_2d(tqkv.reshape(b * n, -1), n, h)
    assert tuple(got[0].shape) == (b * n, h * dh) and tuple(got[1].shape) == (b * n, 1)
    _codes_and_scales_close(got, want, dtype)
    assert twa.fused_qkv_attention_wide_q8_2d.launches == 0


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("b,n,h,dh", EDGE_SHAPES)
def test_k6_plain_version_matches_jax_at_the_plan_edges(b, n, h, dh, serving):
    jqkv, tqkv = _qkv(b, n, h, dh, "bfloat16", seed=37)
    want = jfa.fused_qkv_attention_wide(jqkv, h, None, None, True, serving)
    got = twa.fused_qkv_attention_wide(tqkv, h, serving=serving)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, n, h * dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL["bfloat16"])
    assert twa.fused_qkv_attention_wide.launches == 0


@pytest.mark.parametrize("b,n,h,dh", [(7, 3, 17, 80), (3, 12, 3, 64),
                                      (5, 15, 2, 80), (9, 8, 48, 64)])
def test_k8_below_16_tokens_matches_jax_and_k9(b, n, h, dh):
    """Below 16 tokens K8 runs the flat-row body, as K9 does: on the same
    bytes the two plain versions are equal, and both match the Pallas
    kernel."""
    jqkv, tqkv = _qkv(b, n, h, dh, "bfloat16", seed=41)
    assert twa.q8_plan(n, h, dh) is None
    want = jfa.fused_qkv_attention_wide_q8(jqkv, h, interpret=True)
    q3, s3 = twa.fused_qkv_attention_wide_q8(tqkv, h)
    _codes_and_scales_close((q3, s3), want, "bfloat16")
    q2, s2 = twa.fused_qkv_attention_wide_q8_2d(tqkv.reshape(b * n, -1), n, h)
    assert torch.equal(q2, q3.reshape(b * n, -1))
    assert torch.equal(s2, s3.reshape(b * n, 1))


# ------------------------------------------------ width check and route

def test_the_width_check_after_the_flat_row_redesign():
    """bf16: the flat-row body takes up to 128 heads at any width below 16
    tokens and past 32 heads; float32 keeps its 3072 columns."""
    twa.check_q8_width("k", 4, 128, 80, torch.bfloat16)         # 10240
    twa.check_q8_width("k", 256, 48, 80, torch.bfloat16)        # 3840
    twa.check_q8_width("k", 4, 48, 64, torch.float32)           # 3072
    for args, what in (((4, 129, 64, torch.bfloat16), "128 heads"),
                       ((64, 200, 80, torch.bfloat16), "128 heads"),
                       ((4, 40, 80, torch.float32), "output width")):
        with pytest.raises(ValueError, match=what):
            twa.check_q8_width("k", *args)


# (tokens) of the registered configs -> the serving int8 route and the float
# route: the redesign moved no threshold
ROUTES = [(4, "wide_q8_2d", "wide"), (8, "wide_q8", "wide"),
          (16, "wide_q8", "packed"), (64, "wide_q8", "packed"),
          (256, "packed_q8", "packed")]


@pytest.mark.parametrize("n,q8_route,float_route", ROUTES)
def test_the_route_does_not_move(n, q8_route, float_route):
    assert tattn.attention_route(n, True, True) == (q8_route, True)
    assert tattn.attention_route(n, False, True) == (float_route, False)
    assert tattn.attention_route(n, True, True, attn_q8=False) == (float_route, False)
