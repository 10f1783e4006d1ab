"""K14's fp32 codebook search at the edges of its launch plan, on the CPU:
the plan the CUDA entry follows (``ops/cuda/quantizer.py::vq_f32_plan``,
mirrored from ``csrc/quantizer.cuh``'s ``vq::f32``: 128 rows a block,
256-code tiles, or 128 where the wide tiles would leave SMs idle,
32-column ring slots, z resident or riding the ring, the codebook split
over ranges at few rows), and the port's plain version against
``tae_tpu``'s Pallas kernel in interpret mode where the plan's blocks,
tiles and chunks end.

On the card a block is 16 x 16 threads, each summing an 8 x 16 (or 8 x 8)
tile of (row, code) products in fp32 on the CUDA cores (no TF32);
tests/test_torch_cuda.py holds the kernel to the plain version at these
edges. Ids are compared exactly: both sides add fp32 products of the same
fp32 values, and the seeded inputs hold no near-tie.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.pallas.quantizer import nearest_code_pallas as j_nearest_pallas
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda import quantizer as q

SMS = 132                   # the H100's SMs
SMEM_LIMIT = 232448         # shared memory one H100 block may use


# ------------------------------------------------------------- the plan

def test_f32_plan_mirrors_the_kernel_header():
    text = (build.CSRC_DIR / "quantizer.cuh").read_text()
    f32 = text[text.index("namespace f32 {"):text.index("}  // namespace f32")]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", f32).group(1))

    assert const("kRows") == q.F32_ROWS
    assert const("kCodes") == q.F32_CODES
    assert const("kWideCodes") == q.F32_WIDE_CODES
    assert ("p.codes = p.blocks * ceil_div(k, kWideCodes) >= sms ? kWideCodes : kCodes;"
            in f32)
    assert const("kChunk") == q.F32_CHUNK
    assert "constexpr int kLd = kChunk + 4;" in f32 and q.F32_LD == q.F32_CHUNK + 4
    assert const("kMinStages") == q.F32_MIN_STAGES
    assert const("kMaxStages") == q.F32_MAX_STAGES
    assert const("kThreads") == 256
    assert "return round_up(v, kChunk) + 4;" in f32
    assert "p.resident = smem_bytes(v, p.codes, kMinStages, true) <= kSmemLimit ? 1 : 0;" in f32
    assert "tae_nearest_code_f32_plan" in build.SIGNATURES
    body = (build.CSRC_DIR / "quantizer.cu").read_text()
    # the four instantiations: z resident or riding, 16 or 8 codes a thread
    for form in ("<true, 16>", "<true, 8>", "<false, 16>", "<false, 8>"):
        assert "nearest_code_f32_kernel" + form in body
    # a thread's 8 x NJ tile, the ranges merged as in bf16
    assert "float acc[8][NJ], best[8];" in body and "kCodes = 16 * NJ" in body
    assert body.count("nearest_code_merge_kernel<<<") == 2


@pytest.mark.parametrize("m,v", [(256, 256), (2048, 256), (16384, 256)])
def test_f32_plan_at_the_timed_shapes(m, v):
    """128-row blocks; 256-code tiles at 2048 and 16384 rows, 128 at 256
    rows (2 row blocks x 32 wide tiles would leave 68 SMs idle); about one
    block an SM in all (the codebook split where the row blocks are
    fewer); z resident at V = 256, beside 2 wide or 4 narrow ring slots."""
    plan = q.vq_f32_plan(m, v, 8192, SMS)
    codes = 128 if m == 256 else 256
    tiles = 8192 // codes
    assert (plan.rows, plan.codes, plan.chunk) == (128, codes, 32)
    assert plan.blocks == m // 128
    ranges = 1 if plan.blocks >= SMS else min(tiles, SMS // plan.blocks)
    assert plan.per == -(-tiles // ranges) and plan.splits == -(-tiles // plan.per)
    assert plan.blocks * plan.splits <= SMS
    assert {256: 64, 2048: 8, 16384: 1}[m] == plan.splits
    assert plan.resident == 1 and plan.stages == (4 if codes == 128 else 2)
    assert plan.smem == 4 * 128 * 260 + plan.stages * 4 * codes * 36 + 16 * 128


M_EDGES = [1, 15, 16, 17, 127, 128, 129, 255, 2048, 16384]
K_EDGES = [1, 127, 128, 129, 8192]
V_EDGES = [4, 32, 256, 4096]


@pytest.mark.parametrize("v", V_EDGES)
@pytest.mark.parametrize("k", K_EDGES)
@pytest.mark.parametrize("m", M_EDGES)
def test_f32_plan_covers_every_row_and_code_once(m, k, v):
    """Rows: 128 a block, every row in exactly one block; codes: the
    ranges (grid.y) cover the code tiles exactly, none empty, about one
    block an SM where the row blocks are fewer than the SMs; z resident
    exactly where it fits beside F32_MIN_STAGES slots, the ring as many
    slots as then fit up to F32_MAX_STAGES, within a block's shared
    memory."""
    plan = q.vq_f32_plan(m, v, k, SMS)
    assert plan.rows == 128 and plan.chunk == 32
    assert plan.blocks * plan.rows >= m > (plan.blocks - 1) * plan.rows
    # wide tiles where they still give every SM a block
    wide = plan.blocks * -(-k // 256) >= SMS
    assert plan.codes == (256 if wide else 128)
    tiles = -(-k // plan.codes)
    assert plan.splits * plan.per >= tiles > (plan.splits - 1) * plan.per
    assert plan.splits == 1 or plan.blocks * plan.splits <= SMS
    assert plan.splits <= tiles
    fits = q.f32_smem_bytes(v, plan.codes, q.F32_MIN_STAGES, True) <= SMEM_LIMIT - 1024
    assert bool(plan.resident) == fits == (v <= 256)
    slot = 4 * (plan.codes + (0 if plan.resident else 128)) * 36
    z = 4 * 128 * (-(-v // 32) * 32 + 4) if plan.resident else 0
    assert plan.smem == z + plan.stages * slot + 16 * 128 <= SMEM_LIMIT - 1024
    assert q.F32_MIN_STAGES <= plan.stages <= q.F32_MAX_STAGES
    assert plan.stages == q.F32_MAX_STAGES or plan.smem + slot > SMEM_LIMIT - 1024
    # a resident z row holds whole chunks and an odd number of 16-byte
    # units, so the rows a quarter-warp reads fall in distinct banks
    ldz = -(-v // 32) * 32 + 4
    assert ldz % 32 == 4 and (ldz // 4) % 2 == 1 and (q.F32_LD // 4) % 2 == 1


@pytest.mark.parametrize("m,v,k", [(0, 256, 8), (4, 6, 8), (4, 2, 8), (4, 0, 8),
                                   (4, 256, 0), (-1, 256, 8), (4, 256, 8)])
def test_f32_plan_refuses_what_the_kernel_does_not_take(m, v, k):
    """No rows or codes, or a latent width off the 4-value (16-byte)
    cp.async rows; the last case is taken."""
    plan = q.vq_f32_plan(m, v, k, SMS)
    assert (plan is not None) == (m >= 1 and k >= 1 and v >= 4 and v % 4 == 0)


# --------------------------------- the plain version against the Pallas kernel

# one row, code and vector; rows and codes off the 128 tiles; widths off
# the 32-column chunk; z riding the ring; a split codebook at few rows
EDGES = [(1, 1, 4), (17, 129, 36), (129, 127, 260), (127, 8192, 32),
         (255, 129, 4096), (16, 1, 356), (129, 257, 4)]


@pytest.mark.parametrize("m,k,v", EDGES)
def test_f32_plain_version_matches_pallas_at_the_plan_edges(m, k, v):
    """Ids exact against ``nearest_code_pallas(interpret=True)``."""
    rng = np.random.default_rng(m * 7 + k * 3 + v)
    z = rng.standard_normal((m, v)).astype(np.float32)
    cb = rng.standard_normal((k, v)).astype(np.float32)
    got = q.nearest_code(torch.from_numpy(z), torch.from_numpy(cb))
    assert q.nearest_code.launches == 0
    assert got.dtype == torch.int64 and tuple(got.shape) == (m,)
    want = j_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), block_m=128,
                            block_k=128, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
