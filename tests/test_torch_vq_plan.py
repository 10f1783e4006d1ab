"""K14's bf16 codebook search at the edges of its launch plan, on the CPU:
the plan the CUDA entry follows (``ops/cuda/quantizer.py::vq_plan``,
mirrored from ``csrc/quantizer.cuh``: rows a block, codes a tile, ring
slots, z resident or riding the ring, codebook ranges), and the
port's plain version against ``tae_tpu``'s Pallas kernel in interpret mode
where the plan's blocks, tiles and pipeline steps end.

On the card a block is one producer warp and one or two consumer
warpgroups of 64 rows running wgmma over 128-code tiles, 64 columns a
pipeline step; tests/test_torch_cuda.py holds the kernel to the plain
version at these edges. Ids are compared exactly: both sides add fp32
products of the same fp32 values, and the seeded inputs hold no near-tie.
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
TIMED = [(16384, 256), (2048, 256), (256, 256), (1024, 4096), (256, 16384)]


# ------------------------------------------------------------- the plan

def test_plan_mirrors_the_kernel_header():
    text = (build.CSRC_DIR / "quantizer.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kCols") == q.COLS
    assert const("kCodes") == q.CODES
    assert const("kMinStages") == q.MIN_STAGES
    assert const("kMaxStages") == q.MAX_STAGES
    assert const("kMaxConsumers") == q.MAX_CONSUMERS
    assert re.search(r"constexpr int kSmemLimit = 232448 - 1024;", text)
    assert q.SMEM_LIMIT == SMEM_LIMIT - 1024
    assert const("kPairRows") == q.PAIR_ROWS
    assert "p.consumers = m > 64 && (m >= kPairRows || !z64) ? kMaxConsumers : 1;" in text
    for entry in ("tae_nearest_code_plan", "tae_nearest_code_fwd"):
        assert entry in build.SIGNATURES
    body = (build.CSRC_DIR / "quantizer.cu").read_text()
    # the four instantiations: consumers 1 / 2, z resident / riding
    cases = re.findall(r"  TAE_VQ_CASE\((\d), (true|false)\)", body)
    assert len(set(cases)) == 4
    assert "wgmma_bf16<BN>" in body and "tma_load_2d" in body


@pytest.mark.parametrize("m,v", TIMED)
def test_plan_at_the_timed_shapes(m, v):
    """128-row blocks (two consumer warpgroups) but at 256 rows of 256
    (64), 128-code tiles, about one block an SM in all (the codebook split
    where the row blocks are fewer), z resident at V = 256 (8 ring slots)
    and riding the ring at V = 4096 and 16384 (6 slots), within a block's
    shared memory."""
    plan = q.vq_plan(m, v, 8192, SMS)
    tiles = 8192 // 128
    rows = 64 if (m, v) == (256, 256) else 128
    assert (plan.rows, plan.consumers, plan.codes) == (rows, rows // 64, 128)
    assert plan.blocks == -(-m // rows)
    ranges = 1 if plan.blocks >= SMS else min(tiles, SMS // plan.blocks)
    assert plan.per == -(-tiles // ranges) and plan.splits == -(-tiles // plan.per)
    assert plan.blocks * plan.splits <= SMS
    assert plan.resident == (v == 256)
    assert plan.stages == (8 if v == 256 else 6)
    assert plan.smem <= SMEM_LIMIT - 1024


M_EDGES = [1, 63, 64, 65, 127, 128, 129, 16383, 16385]
K_EDGES = [1, 127, 128, 129, 8192]
V_EDGES = [8, 64, 72, 256, 1024, 1480, 4096, 16384]


@pytest.mark.parametrize("v", V_EDGES)
@pytest.mark.parametrize("k", K_EDGES)
@pytest.mark.parametrize("m", M_EDGES)
def test_plan_covers_every_row_and_code_once(m, k, v):
    """Rows: 64 a block up to 64 rows, 128 from 512 and where 64-row
    blocks would not keep z resident; codes: the ranges
    (grid.y) cover the code tiles exactly, none empty; the ring's slots and
    z's resident slabs start on the 128-byte swizzle's 1024-byte units, and
    at least MIN_STAGES slots stand beside a resident z."""
    plan = q.vq_plan(m, v, k, SMS)
    z64 = q.smem_bytes(64, q.CODES, q.MIN_STAGES, v, True) <= q.SMEM_LIMIT
    assert plan.rows == (128 if m > 64 and (m >= 512 or not z64) else 64)
    assert plan.rows == 64 * plan.consumers
    assert plan.blocks * plan.rows >= m > (plan.blocks - 1) * plan.rows
    tiles = -(-k // plan.codes)
    assert plan.splits * plan.per >= tiles > (plan.splits - 1) * plan.per
    assert plan.splits == 1 or plan.blocks * plan.splits <= SMS
    slot = q.slot_bytes(plan.rows, plan.codes, bool(plan.resident))
    assert slot % 1024 == 0 and (plan.rows * 128) % 1024 == 0
    assert slot >= plan.codes * 128 + plan.codes * 4 + (0 if plan.resident else plan.rows * 128)
    z = -(-v // 64) * plan.rows * 128 if plan.resident else 0
    assert plan.smem == z + plan.stages * slot + 1024 <= SMEM_LIMIT - 1024
    assert q.MIN_STAGES <= plan.stages <= q.MAX_STAGES or not plan.resident
    assert plan.stages >= 2
    # z resident exactly where it fits beside MIN_STAGES slots
    fits = q.smem_bytes(plan.rows, plan.codes, q.MIN_STAGES, v, True) <= q.SMEM_LIMIT
    assert bool(plan.resident) == fits


@pytest.mark.parametrize("m,v,k", [(0, 256, 8), (4, 12, 8), (4, 4, 8), (4, 256, 0),
                                   (-1, 256, 8)])
def test_plan_refuses_what_the_kernel_does_not_take(m, v, k):
    """No rows or codes, or a latent width off the 8-value (16-byte) TMA
    rows."""
    assert q.vq_plan(m, v, k, SMS) is None


# --------------------------------- the plain version against the Pallas kernel

# rows off a 64-row block, codes off a 128-code tile, widths of one vector,
# part of a second 64-column step, past z's resident widths, and p64's
EDGES = [(1, 1, 8), (65, 127, 72), (129, 129, 1480), (65, 129, 4096),
         (129, 1, 72), (1, 127, 1480), (129, 127, 8), (1, 129, 4096)]


@pytest.mark.parametrize("m,k,v", EDGES)
def test_plain_version_matches_pallas_at_the_plan_edges(m, k, v):
    """Ids exact against ``nearest_code_pallas(interpret=True)`` (its
    blocks cut at 64 rows and 128 codes, as the plan cuts them)."""
    rng = np.random.default_rng(m * 7 + k * 3 + v)
    z = rng.standard_normal((m, v)).astype(np.float32)
    cb = rng.standard_normal((k, v)).astype(np.float32)
    got = q.nearest_code(torch.from_numpy(z), torch.from_numpy(cb))
    assert q.nearest_code.launches == 0
    assert got.dtype == torch.int64 and tuple(got.shape) == (m,)
    want = j_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), block_m=64,
                            block_k=128, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 127, 129])
def test_plain_version_gives_a_tie_to_the_lowest_index(k):
    """One code three times across the last tile's edge, and all codes
    equal: the lowest index, as the Pallas kernel's argmin."""
    rng = np.random.default_rng(k)
    cb = rng.standard_normal((k, 72)).astype(np.float32)
    cb[k - 1] = cb[k // 2] = cb[0]
    z = np.repeat(cb[:1], 65, axis=0)
    got = q.nearest_code(torch.from_numpy(z), torch.from_numpy(cb))
    assert bool((got == 0).all())
    want = j_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), block_m=64,
                            block_k=128, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    same = np.zeros_like(cb)
    assert int(q.nearest_code(torch.from_numpy(z), torch.from_numpy(same)).max()) == 0
