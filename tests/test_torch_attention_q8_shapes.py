"""K7 and K8 (the int8-output attention entries) at the edges of the
per-image body's tiling, on the CPU: the port's plain versions against
``tae_tpu.ops.pallas.flash_attention.fused_qkv_attention_q8`` and
``fused_qkv_attention_wide_q8`` in interpret mode, the launch plan the CUDA
entries follow (``q8_plan``, mirrored from ``csrc/attention_q8.cuh``), the
width check, and the dispatch rule after the K7 / K2 + quantize comparison
on the card.

Inputs are made with numpy from a seed and fed to both packages. On the
card the body runs 16 query rows a warp, up to 8 warps a block, 64-key
chunks, and the heads of one (image, row tile) over a thread-block cluster
whose last rank may take fewer heads; the shapes here sit on those edges
(tokens 1, 63, 65, 129, 255, 256; 2, 3, 12 and 16 heads at head dims 64 and
80). tests/test_torch_cuda.py holds the kernels to these plain versions.

Tolerances (as tests/test_torch_wide_attention.py): both sides round the
same fp32 o * (1 / s) to codes, and o can differ in its last bits
(summation order), so codes may differ by one step on at most 1e-3 of the
elements. Scales are amax / 127 of o: in fp32 rtol 4e-6, because XLA under
jit turns the division into a product with 1/127 (one ulp) and each o sums
up to 256 products in another order than the port's matmul (measured up to
1.14e-6 at 129 tokens, 16 heads). In bf16 the P.V product
takes p rounded to bf16, and a p whose fp32 value differs in its last bits
can round to the neighbouring bf16 value: on at most 1% of the rows the
scale may move by up to 2e-2.
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

CODE_FLIP_SHARE = 1e-3
SCALE_RTOL = 4e-6
BF16_SCALE_SHARE, BF16_SCALE_RTOL = 1e-2, 2e-2
B = 3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (tokens, heads, head dim): every token count of the tiling's edges, each
# head count at both head dims
SHAPES = [(1, 2, 64), (1, 3, 80), (63, 12, 64), (63, 16, 80),
          (65, 3, 64), (65, 12, 80), (129, 2, 80), (129, 16, 64),
          (255, 12, 64), (255, 3, 80), (256, 16, 64), (256, 2, 80)]


def _qkv(n, h, dh, dtype, seed=5, last_head=1.0, zero_image=False):
    """The same packed qkv (B, n, 3C) for both packages, rounded to
    ``dtype``; ``last_head`` scales v of the last head, ``zero_image`` sets
    v of image 0 to 0."""
    c = h * dh
    x = np.random.default_rng(seed).standard_normal(
        (B, n, 3 * c)).astype(np.float32)
    x[..., 3 * c - dh:] *= last_head
    if zero_image:
        x[0, :, 2 * c:] = 0.0
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _jax_q8(jqkv, h):
    """The JAX entry of the token count: per-image above 64, wide up to."""
    fn = (jfa.fused_qkv_attention_q8 if jqkv.shape[1] > 64
          else jfa.fused_qkv_attention_wide_q8)
    return fn(jqkv, h, interpret=True)


def _port_q8(tqkv, h):
    fn = (twa.fused_qkv_attention_q8 if tqkv.shape[1] > 64
          else twa.fused_qkv_attention_wide_q8)
    return fn(tqkv, h)


def _close(got, want, dtype):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,dh", SHAPES)
def test_q8_entries_match_jax_at_the_tiling_edges(n, h, dh, dtype):
    jqkv, tqkv = _qkv(n, h, dh, dtype)
    got = _port_q8(tqkv, h)
    assert tuple(got[0].shape) == (B, n, h * dh)
    assert tuple(got[1].shape) == (B, n, 1)
    _close(got, _jax_q8(jqkv, h), dtype)


@pytest.mark.parametrize("n,h,dh", [(256, 16, 64), (129, 3, 80),
                                    (63, 12, 64), (16, 16, 80)])
def test_a_dominant_last_head_sets_every_scale(n, h, dh):
    """v of the last head x 8: every row's largest output lies in the last
    cluster rank's heads, so a scale over any other heads alone is wrong."""
    jqkv, tqkv = _qkv(n, h, dh, "bfloat16", seed=9, last_head=8.0)
    got = _port_q8(tqkv, h)
    _close(got, _jax_q8(jqkv, h), "bfloat16")
    o = twa.packed_attention_f32(tqkv, h, serving=True)
    last = o[..., (h - 1) * dh:].abs().amax(-1, keepdim=True)
    assert torch.equal(got[1], last / 127.0)


@pytest.mark.parametrize("n,h,dh", [(256, 16, 64), (65, 12, 80), (1, 2, 64)])
def test_zero_rows_take_the_floor_scale_and_zero_codes(n, h, dh):
    jqkv, tqkv = _qkv(n, h, dh, "float32", seed=4, zero_image=True)
    q, s = _port_q8(tqkv, h)
    _close((q, s), _jax_q8(jqkv, h), "float32")
    assert bool((s[0] == 1e-12).all()) and not bool(q[0].any())
    assert bool((s[1:] > 1e-12).all())


# ------------------------------------------------------------ the plan

# (tokens, heads, head dim) -> (cluster, heads a block, warps, shared bytes):
# the registered int8 shapes (p16, p32, p64) and edges of the rule
PLANS = [
    ((256, 16, 64), (8, 2, 8, 4 * 256 * 72 + 4 * 128 * 72 + 4 * 128)),
    ((64, 32, 64), (16, 2, 4, 4 * 64 * 72 + 4 * 64 * 72 + 4 * 64)),
    ((16, 32, 80), (16, 2, 1, 4 * 16 * 88 + 4 * 16 * 88 + 4 * 16)),
    ((65, 12, 64), (6, 2, 5, 4 * 80 * 72 + 4 * 80 * 72 + 4 * 80)),
    ((129, 17, 80), (9, 2, 8, 4 * 144 * 88 + 4 * 128 * 88 + 4 * 128)),
    ((255, 1, 64), (1, 1, 8, 4 * 256 * 72 + 4 * 128 * 72 + 4 * 128)),
    ((100, 31, 80), (16, 2, 7, 4 * 112 * 88 + 4 * 112 * 88 + 4 * 112)),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_q8_plan_at_the_registered_shapes_and_edges(shape, want):
    assert twa.q8_plan(*shape) == twa.Q8Plan(*want)


def test_q8_plan_covers_every_head_count_once():
    """heads a block = min(H, 2), cluster = ceil(H / that): at most 16
    blocks, every head in exactly one block, the last rank taking one head
    where H is odd; more than 32 heads go to the flat-row body."""
    for h in range(1, 41):
        plan = twa.q8_plan(256, h, 80)
        if h > twa.Q8_HEADS_PER_BLOCK * twa.Q8_MAX_CLUSTER:
            assert plan is None
            continue
        hpb, cluster = plan.heads_per_block, plan.cluster
        assert 1 <= cluster <= twa.Q8_MAX_CLUSTER
        assert hpb == min(h, twa.Q8_HEADS_PER_BLOCK)
        assert (cluster - 1) * hpb < h <= cluster * hpb
        assert plan.smem <= twa.SMEM_LIMIT


@pytest.mark.parametrize("args", [(256, 16, 64, torch.float32),
                                  (15, 16, 64, torch.bfloat16),
                                  (4, 32, 80, torch.bfloat16),
                                  (257, 16, 64, torch.bfloat16),
                                  (64, 16, 96, torch.bfloat16),
                                  (256, 33, 64, torch.bfloat16)])
def test_q8_plan_leaves_the_rest_to_the_flat_row_body(args):
    """float32, fewer than 16 tokens, more than 256, another head dim, or
    more than 32 heads."""
    assert twa.q8_plan(*args) is None


def test_q8_plan_mirrors_the_kernel_header():
    text = (build.CSRC_DIR / "attention_q8.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kMaxCluster") == twa.Q8_MAX_CLUSTER
    assert const("kHeadsPerBlock") == twa.Q8_HEADS_PER_BLOCK
    assert const("kMinTokens") == twa.Q8_MIN_TOKENS
    assert pathlib.Path(build.CSRC_DIR / "flash_attention.cu").is_file()


def test_the_width_check_follows_the_body():
    """The per-image body takes up to 32 heads, whatever their width; the
    flat-row body in bf16 up to 128 heads (16 blocks of 8, a cluster),
    whatever their width; in float32 what the bodies' shared memory holds
    (from 33 tokens the tiled body: up to 112 heads of 80); beyond them the
    wrapper raises."""
    twa.check_q8_width("k", 256, 32, 80, torch.bfloat16)          # 2560
    twa.check_q8_width("k", 4, 48, 64, torch.bfloat16)            # 3072
    twa.check_q8_width("k", 256, 48, 64, torch.bfloat16)          # 3072
    twa.check_q8_width("k", 4, 50, 64, torch.bfloat16)            # 3200
    twa.check_q8_width("k", 256, 128, 80, torch.bfloat16)         # 10240
    twa.check_q8_width("k", 256, 40, 80, torch.float32)           # 3200
    for args in ((4, 129, 64, torch.bfloat16), (256, 113, 80, torch.float32),
                 (256, 129, 64, torch.bfloat16)):
        with pytest.raises(ValueError, match="output width"):
            twa.check_q8_width("k", *args)


# -------------------------------------------------------- route after C5

# (tokens, heads) of the registered int8 configs -> route of a serving int8
# block: K7 beat K2 + the plain quantize on the card at p16 (B = 64), K8 at
# p32 and p64, so the int8 output stays at every token count
ROUTES = [((256, 16), "packed_q8"), ((65, 12), "packed_q8"),
          ((64, 32), "wide_q8"), ((16, 32), "wide_q8"), ((8, 2), "wide_q8"),
          ((4, 32), "wide_q8_2d")]


@pytest.mark.parametrize("shape,route", ROUTES)
def test_the_int8_route_after_the_card_comparison(shape, route):
    n, _ = shape
    assert tattn.attention_route(n, True, True) == (route, True)
    assert tattn.attention_route(n, True, True, attn_q8=False)[1] is False
    assert tattn.attention_route(n, True, False) == (
        "wide" if n <= tattn.FLOAT_WIDE_MAX_TOKENS else "packed", False)
