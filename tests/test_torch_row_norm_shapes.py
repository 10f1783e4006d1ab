"""The LayerNorm row kernels, K3 ``ln_quant`` and K11 (the LayerNorm
backward), at the edges of their launch plans, on the CPU: the plans the
CUDA entries follow (``ln_quant_plan`` in ``ops/cuda/int8_block.py`` and
``bwd_plan`` in ``ops/cuda/layernorm.py``, both mirrored from
``csrc/row_norm.cuh``), and the port's plain versions against
``tae_tpu.ops.pallas`` in interpret mode at row counts and widths where
those plans' blocks, chunks and register rows end.

On the card both kernels take one warp a row and hold the row in
registers: a lane holds nv groups of 8 columns, nv the first of 1, 2, 4,
8, 10, 12, 16 that covers the row. K3 does so up to 4096 columns and packs
1, 2 or 4 rows a block (4 from 256 rows on); K11 up to 2560
columns, in blocks of 8 warps over chunks of 128 rows (from 16384 rows;
fewer rows in up to 128 chunks of a multiple of 8 rows), its column sums
in registers up to 1024 columns and in shared memory above. Wider rows run
the first designs' runtime loops. tests/test_torch_cuda.py holds the
kernels to these plain versions.

Tolerances: K3 as tests/test_torch_int8_ops.py (codes off by one on at
most 1e-3 of the elements, scales rtol 1e-6: both packages round the same
fp32 value, which can differ in its last bits); K11 as
tests/test_torch_train_ops.py (fp32 atol = rtol = 1e-4: the column sums
add up to 1001 terms of size ~1 in another order; bf16 atol 1e-3, rtol
2^-7: fp32 sums rounded once to bf16, one bf16 ulp).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ops.pallas.int8_block import ln_quant as j_ln_quant
from tae_tpu.ops.pallas.layernorm import fused_layer_norm as j_fln
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda import int8_block as ib
from tae_tpu_torch.ops.cuda import layernorm as ln
from tae_tpu_torch.ops.layernorm import (layer_norm_backward_reference,
                                         layer_norm_stats_reference)

CODE_FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-6
GRAD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=1e-3, rtol=2.0 ** -7)}
SMEM_LIMIT = 232448          # dynamic shared memory of one H100 block
MAX_GRID_Y = 65535
SMS = 132                    # the H100's SMs
WIDTHS = (1024, 2048, 2560)  # the registered models' widths
ROWS = (16384, 4096, 256, 32, 4, 1001, 1)


# ------------------------------------------------------------- the plans

@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("cols", WIDTHS)
def test_ln_quant_plan_at_the_registered_shapes(cols, rows):
    """nv = cols / 256 (4, 8, 10: the register body), rows a block 4 from
    256 rows on, 2 from 128, else 1, every row in one block."""
    plan = ib.ln_quant_plan(rows, cols)
    assert plan.nv == cols // 256
    assert plan.warps == (4 if rows >= 256 else 2 if rows >= 128 else 1)
    assert (plan.blocks - 1) * plan.warps < rows <= plan.blocks * plan.warps


def test_ln_quant_plan_at_p128():
    """p128 at B = 64: 256 rows in 64 blocks of 4 warps (measured faster
    than 128 of 2 or 256 of 1: the warps of a block share gamma and beta
    through L1); at B = 8 and 1, a block a row, a block on an SM each."""
    assert ib.ln_quant_plan(256, 2560) == ib.LnQuantPlan(10, 4, 64)
    assert ib.ln_quant_plan(32, 2560) == ib.LnQuantPlan(10, 1, 32)
    assert ib.ln_quant_plan(32, 2560).blocks <= SMS
    assert ib.ln_quant_plan(4, 2560) == ib.LnQuantPlan(10, 1, 4)
    assert ib.ln_quant_plan(16384, 1024) == ib.LnQuantPlan(4, 4, 4096)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("cols", WIDTHS)
def test_bwd_plan_at_the_registered_shapes(cols, rows):
    """Chunks cover every row once: 128 rows a chunk from 16384 rows (the
    first design's chunks: 128 blocks), below that a multiple of 8 rows a
    chunk, at most 128 chunks; 8 warps; the column sums in registers at
    1024 columns, in shared memory at 2048 and 2560; the shared memory
    within a block's."""
    plan = ln.bwd_plan(rows, cols)
    assert plan.nv == cols // 256 and plan.warps == 8
    per = plan.rows_per_chunk
    if rows >= 16384:
        assert per == 128
    else:
        assert per % 8 == 0 and plan.chunks <= 128
        assert per == 8 or -(-rows // (per - 8)) > 128   # the fewest such rows
    assert (plan.chunks - 1) * per < rows <= plan.chunks * per
    assert 1 <= plan.chunks <= MAX_GRID_Y
    assert plan.reg_acc == (cols == 1024)
    assert plan.smem == (2 * 8 + 1) * cols * 4 <= SMEM_LIMIT
    # few chunks split the columns: grid.y slices of 256-column groups, at
    # most 128 blocks in all
    if plan.chunks <= 64:
        assert plan.splits == min(128 // plan.chunks, cols // 256) > 1
        assert plan.chunks * plan.splits <= 128
    else:
        assert plan.splits == 1


def test_bwd_plan_spreads_few_rows_over_the_card():
    """p128_train's 32 rows of 2560: 4 chunks of 8 rows (a row a warp) x 10
    column slices (the first design ran 1 chunk, its dx kernel 8 blocks);
    p16's 16384 rows: the first design's 128 chunks, unsplit."""
    assert ln.bwd_plan(32, 2560) == ln.BwdPlan(10, 4, 8, 8, 0, 17 * 2560 * 4, 10)
    assert ln.bwd_plan(16384, 1024) == ln.BwdPlan(4, 128, 128, 8, 1, 17 * 1024 * 4, 1)
    assert ln.bwd_plan(1001, 2560).splits == 1
    assert ln.bwd_plan(512, 2048) == ln.BwdPlan(8, 64, 8, 8, 0, 17 * 2048 * 4, 2)


# (rows) -> (chunks, rows a chunk): a row a warp up to 1024 rows, then more
# rows a chunk up to the first design's 128 at 16384 rows, then 1024 chunks
# at most
CHUNKS = [(1, 1, 8), (32, 4, 8), (129, 17, 8), (1001, 126, 8), (1025, 65, 16),
          (2048, 128, 16), (16383, 128, 128), (16384, 128, 128),
          (131072, 1024, 128), (131073, 1017, 129), (2 ** 31 - 1, 1024, 2 ** 21)]


@pytest.mark.parametrize("rows,chunks,per", CHUNKS)
def test_bwd_plan_chunks_cover_every_row_once(rows, chunks, per):
    """At most 1024 chunks, the last one part-filled at most."""
    plan = ln.bwd_plan(rows, 1024)
    assert (plan.chunks, plan.rows_per_chunk) == ln.bwd_row_chunks(rows) == (chunks, per)
    assert chunks * per >= rows > (chunks - 1) * per
    assert chunks <= ln.BWD_MAX_CHUNKS


# (cols) -> (K3's nv, K11's nv): one group, part of a second, the widest
# register rows of each, and the first widths past them (0: the first
# designs' loops)
EDGES = [(8, 1, 1), (264, 2, 2), (776, 4, 4), (1032, 8, 8), (2568, 12, 0),
         (4096, 16, 0), (4104, 0, 0), (8192, 0, 0)]


@pytest.mark.parametrize("cols,k3_nv,k11_nv", EDGES)
def test_plans_at_their_width_edges(cols, k3_nv, k11_nv):
    """nv the first of 1, 2, 4, 8, 10, 12, 16 that covers cols / 256; K3's
    register body to 4096 columns, K11's to 2560; no shared memory where
    K11 runs its first design."""
    assert ln.nv_for(cols, ib.LNQ_MAX_NV) == k3_nv
    assert ib.ln_quant_plan(5, cols).nv == k3_nv
    plan = ln.bwd_plan(5, cols)
    assert plan.nv == k11_nv
    assert plan.smem == ((2 * 8 + 1) * k11_nv * 256 * 4 if k11_nv else 0)
    assert plan.smem <= SMEM_LIMIT
    for nv in (k3_nv, k11_nv):
        assert nv == 0 or cols <= nv * 256


@pytest.mark.parametrize("rows,cols", [(0, 1024), (4, 12), (4, 1030), (4, 0),
                                       (-1, 2560)])
def test_plans_refuse_what_the_kernels_do_not_take(rows, cols):
    """No rows, or a width that is not a positive multiple of 8."""
    assert ib.ln_quant_plan(rows, cols) is None
    assert ln.bwd_plan(rows, cols) is None


def test_row_norm_plans_mirror_the_kernel_header():
    text = (build.CSRC_DIR / "row_norm.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    steps = re.search(r"constexpr int kNvSteps\[\] = \{([\d, ]+)\};", text).group(1)
    assert tuple(int(s) for s in steps.split(",")) == ln.NV_STEPS
    assert const("kGroupCols") == ln.GROUP_COLS
    assert const("kLnqMaxNv") == ib.LNQ_MAX_NV
    assert const("kLnqMaxWarps") == ib.LNQ_MAX_WARPS
    assert const("kFillBlocks") == ln.FILL_BLOCKS
    assert const("kLnqMinBlocks") == ib.LNQ_MIN_BLOCKS
    assert const("kBwdL2Ahead") >= 1
    assert const("kBwdMaxNv") == ln.BWD_MAX_NV
    assert const("kBwdRegAccNv") == ln.BWD_REG_ACC_NV
    assert const("kBwdWarps") == ln.BWD_WARPS
    assert const("kBwdRowsPerChunk") == ln.BWD_ROWS_PER_CHUNK
    assert const("kBwdMaxChunks") == ln.BWD_MAX_CHUNKS
    for entry in ("tae_ln_quant_plan", "tae_layer_norm_bwd_plan"):
        assert entry in build.SIGNATURES
    # each nv a kernel body is instantiated at, K3 to 16 and K11 to 10
    for src, name, top in (("int8_block.cu", "TAE_LNQ_CASE", 16),
                           ("layernorm.cu", "TAE_BWD_CASE", 10)):
        body = (build.CSRC_DIR / src).read_text()
        cases = tuple(int(n) for n in re.findall(rf"    {name}\((\d+)\)", body))
        assert cases == tuple(n for n in ln.NV_STEPS if n <= top)


# ------------------------------------------- the plain versions against JAX

def _inputs(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, cols)) * 3 + 1).astype(np.float32)
    w = (rng.standard_normal(cols) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(cols) * 0.2).astype(np.float32)
    dy = rng.standard_normal((rows, cols)).astype(np.float32)
    return x, w, b, dy


# rows that leave a 4-warp block, a 128-row chunk and JAX's 256-row block
# part-filled, at p16's and p128's widths
PLAIN_SHAPES = [(1, 1024), (129, 1024), (1001, 1024), (1, 2560), (129, 2560),
                (1001, 2560)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", PLAIN_SHAPES)
def test_k3_plain_version_matches_jax(rows, cols, dtype):
    x, w, b, _ = _inputs(rows, cols, seed=17)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    q_j, s_j = j_ln_quant(*(jnp.asarray(a, jd) for a in (x, w, b)), 1e-6,
                          interpret=True)
    args = [torch.from_numpy(a).to(td) for a in (x, w, b)]
    q, s = ib.ln_quant(*args, 1e-6)      # the plain version on the CPU
    assert ib.ln_quant.launches == 0
    assert q.dtype == torch.int8 and tuple(q.shape) == (rows, cols)
    assert s.dtype == torch.float32 and tuple(s.shape) == (rows, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=SCALE_RTOL, atol=0)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_j, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FLIP_SHARE
    q2, s2 = ib.ln_quant_reference(*args, 1e-6)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", PLAIN_SHAPES)
def test_k11_plain_version_matches_jax(rows, cols, dtype):
    """dx, dw and db of the backward formula against jax.vjp of the Pallas
    LayerNorm; in bf16 the weight is the activations' dtype, as the model
    hands it over, so dw and db come back in bf16 on both sides."""
    x, w, b, dy = _inputs(rows, cols, seed=23)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda *a: j_fln(*a, 1e-6, True),
                     *(jnp.asarray(a, jd) for a in (x, w, b)))
    want = vjp(jnp.asarray(dy, jd))
    tx, tw, tb, tdy = (torch.from_numpy(a).to(td) for a in (x, w, b, dy))
    _, mean, rstd = layer_norm_stats_reference(tx, tw, tb, 1e-6)
    got = ln.fused_layer_norm_bwd(tx, tw, mean, rstd, tdy)
    assert ln.fused_layer_norm_bwd.launches == 0
    assert [g.dtype for g in got] == [td] * 3
    same = layer_norm_backward_reference(tx, tw, mean, rstd, tdy)
    assert all(torch.equal(a, c) for a, c in zip(got, same))
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == tuple(wnt.shape)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(jnp.asarray(wnt, jnp.float32)),
                                   **GRAD_TOL[dtype])
