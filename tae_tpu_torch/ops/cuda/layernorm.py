"""K1 and K11: fused LayerNorm forward and backward (counterparts of
``tae_tpu/ops/pallas/layernorm.py``::``fused_layer_norm`` and its VJP,
``_fln_fwd`` / ``_fln_bwd``; source ``tae_tpu_torch/csrc/layernorm.cu``,
launch plans ``csrc/row_norm.cuh``, mirrored by :func:`fwd_plan` and
:func:`bwd_plan`).

:func:`fused_layer_norm` is the entry. Where autograd records, it runs as
:class:`FusedLayerNormFn`: the forward that also saves each row's mean and
rstd (:func:`fused_layer_norm_fwd_stats`) and the backward kernel
(:func:`fused_layer_norm_bwd`). Otherwise it is the inference forward, which
writes y only. The three launch counts are kept apart, so a serving run
shows no training launch and the reverse.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.layernorm import (layer_norm_backward_reference,
                                         layer_norm_reference,
                                         layer_norm_stats_reference)

_DTYPES = (torch.float32, torch.bfloat16)

# The row kernels' launch plans, mirrored from csrc/row_norm.cuh (K3's is
# ops/cuda/int8_block.py::ln_quant_plan): a lane holds nv groups of 8
# columns, nv the first of NV_STEPS that covers the row.
NV_STEPS = (1, 2, 4, 8, 10, 12, 16)
GROUP_COLS = 256
#: blocks that cover the card (about one for each of the H100's 132 SMs)
FILL_BLOCKS = 128
#: K1 (both entries): the row in registers up to FWD_MAX_NV groups (4096
#: columns), wider rows through the first design; FWD_MAX_WARPS warps (rows)
#: a block, halved while the grid would have fewer than FWD_MIN_BLOCKS
#: blocks (K3's plan)
FWD_MAX_NV = 16
FWD_MAX_WARPS = 4
FWD_MIN_BLOCKS = 64
#: K11: the row in registers up to BWD_MAX_NV groups (2560 columns), wider
#: rows through the first design's three launches; each warp's column sums
#: in registers up to BWD_REG_ACC_NV groups (1024 columns), in shared memory
#: above; BWD_WARPS warps a block taking a chunk's rows in turn; chunks as
#: :func:`bwd_row_chunks` says
BWD_MAX_NV = 10
BWD_REG_ACC_NV = 4
BWD_WARPS = 8
BWD_ROWS_PER_CHUNK = 128
BWD_MAX_CHUNKS = 1024


def nv_for(cols: int, max_nv: int) -> int:
    """``tae::rownorm::nv_for``: the first of :data:`NV_STEPS` that covers
    ``cols`` columns in groups of 256, or 0 above ``max_nv``."""
    need = -(-cols // GROUP_COLS)
    return next((nv if nv <= max_nv else 0 for nv in NV_STEPS if nv >= need), 0)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """K1's launch: ``nv`` 8-column groups a lane holds (0: the first
    design's loop, 4 warps a block), ``warps`` rows a block of the register
    body, ``blocks``."""
    nv: int
    warps: int
    blocks: int


def fwd_plan(rows: int, cols: int) -> FwdPlan | None:
    """The plan ``tae::rownorm::layer_norm_fwd_plan`` computes for K1, or
    None where the kernels do not take the shape (no rows, a width that is
    not a multiple of 8)."""
    if rows < 1 or cols < 8 or cols % 8:
        return None
    warps = FWD_MAX_WARPS
    while warps > 1 and rows < warps * FWD_MIN_BLOCKS:
        warps //= 2
    return FwdPlan(nv_for(cols, FWD_MAX_NV), warps, -(-rows // warps))


def fwd_plan_of_library(rows: int, cols: int) -> FwdPlan | None:
    """The built library's K1 plan for (rows, cols): what ``chip_smoke.py``
    holds :func:`fwd_plan` against. Needs the card's build."""
    out = (ctypes.c_int * 4)()
    build.check(build.library().tae_layer_norm_fwd_plan(rows, cols, out),
                "tae_layer_norm_fwd_plan")
    return FwdPlan(*out[1:4]) if out[0] else None


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """K11's launch: ``nv`` 8-column groups a lane (0: the first design's
    launches), ``chunks`` blocks of ``rows_per_chunk`` rows along grid.x,
    ``warps`` a block, the column sums in registers (``reg_acc``) or shared
    memory, ``smem`` bytes of dynamic shared memory a block, ``splits``
    slices of the columns along grid.y."""
    nv: int
    chunks: int
    rows_per_chunk: int
    warps: int
    reg_acc: int
    smem: int
    splits: int


def bwd_row_chunks(rows: int) -> tuple[int, int]:
    """``(chunks, rows per chunk)`` of K11's column sums: chunks of
    :data:`BWD_ROWS_PER_CHUNK` rows where that makes :data:`FILL_BLOCKS`
    chunks or more (more rows a chunk where there would be over
    :data:`BWD_MAX_CHUNKS`); fewer rows take the fewest rows a chunk, a
    multiple of :data:`BWD_WARPS`, that make at most :data:`FILL_BLOCKS`
    chunks."""
    per = -(-rows // BWD_MAX_CHUNKS)
    if per < BWD_ROWS_PER_CHUNK:
        if rows >= BWD_ROWS_PER_CHUNK * FILL_BLOCKS:
            per = BWD_ROWS_PER_CHUNK
        else:
            per = -(-(-(-rows // FILL_BLOCKS)) // BWD_WARPS) * BWD_WARPS
    return -(-rows // per), per


def bwd_plan(rows: int, cols: int) -> BwdPlan | None:
    """The plan ``tae::rownorm::layer_norm_bwd_plan`` computes for K11, or
    None where the kernels do not take the shape (no rows, a width that is
    not a multiple of 8). Shared memory: the weight in fp32 and each warp's
    two column sums, nv groups wide. Where the chunks are FILL_BLOCKS / 2 or
    fewer, the columns are split into up to FILL_BLOCKS / chunks slices of
    256-column groups (a block reads its rows whole for their means and
    writes dx and the sums of its slice)."""
    if rows < 1 or cols < 8 or cols % 8:
        return None
    chunks, per = bwd_row_chunks(rows)
    nv = nv_for(cols, BWD_MAX_NV)
    smem = (2 * BWD_WARPS + 1) * nv * GROUP_COLS * 4 if nv else 0
    splits = (min(FILL_BLOCKS // chunks, -(-cols // GROUP_COLS))
              if nv and chunks <= FILL_BLOCKS // 2 else 1)
    return BwdPlan(nv, chunks, per, BWD_WARPS,
                   int(0 < nv <= BWD_REG_ACC_NV), smem, splits)


def bwd_plan_of_library(rows: int, cols: int) -> BwdPlan | None:
    """The built library's K11 plan for (rows, cols): what ``chip_smoke.py``
    holds :func:`bwd_plan` against. Needs the card's build."""
    out = (ctypes.c_int * 8)()
    build.check(build.library().tae_layer_norm_bwd_plan(rows, cols, out),
                "tae_layer_norm_bwd_plan")
    return BwdPlan(*out[1:8]) if out[0] else None


def _check(name: str, x, weight, bias, extra=()) -> tuple[int, int]:
    """Raise on what the kernels do not take; returns (rows, D)."""
    if not x.is_cuda:
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32/bfloat16, got x {x.dtype}, "
                        f"weight {weight.dtype}")
    if bias is not None and bias.dtype != weight.dtype:
        raise TypeError(f"weight {weight.dtype} and bias {bias.dtype} differ")
    if weight.shape != (d,) or (bias is not None and bias.shape != (d,)):
        raise ValueError(f"weight {tuple(weight.shape)} / bias do not match "
                         f"D={d}")
    if d % 8 or d < 8:
        raise ValueError(f"{name} needs D a multiple of 8, got {d}")
    named = [("x", x), ("weight", weight), ("bias", bias), *extra]
    for label, t in named:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{label} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {label}")
    for label, t in named[:3]:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} needs a 16-byte aligned {label}")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"{name} takes < 2**31 rows, got {rows}")
    return rows, d


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., D), fp32 statistics, output in
    x's dtype. x: float32 or bfloat16; weight, bias: (D,), both float32 or
    both bfloat16. On CUDA: D a multiple of 8, x, weight and bias
    contiguous and 16-byte aligned. Differentiable: where
    autograd records through x, weight or bias, the training forward and the
    backward kernel run."""
    if build.needs_grad(x, weight, bias):
        return FusedLayerNormFn.apply(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    rows, d = _check("fused_layer_norm", x, weight, bias)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    rc = build.library().tae_layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        rows, d, float(eps), build.dtype_code(x.dtype),
        build.dtype_code(weight.dtype), _stream(x))
    build.check(rc, "tae_layer_norm_fwd")
    fused_layer_norm.launches += 1
    return y


fused_layer_norm.launches = 0


def fused_layer_norm_fwd_stats(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, eps: float = 1e-6):
    """The training forward: ``(y, mean, rstd)``, the statistics fp32 and
    flat ``(M,)``. No gradient of its own: :class:`FusedLayerNormFn` calls
    it."""
    if x.device.type == "cpu":
        return layer_norm_stats_reference(x, weight, bias, eps)
    rows, d = _check("fused_layer_norm_fwd_stats", x, weight, bias)
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mean, rstd
    rc = build.library().tae_layer_norm_fwd_stats(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, d, float(eps),
        build.dtype_code(x.dtype), build.dtype_code(weight.dtype), _stream(x))
    build.check(rc, "tae_layer_norm_fwd_stats")
    fused_layer_norm_fwd_stats.launches += 1
    return y, mean, rstd


fused_layer_norm_fwd_stats.launches = 0


def fused_layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         dy: torch.Tensor):
    """K11: ``(dx, dw, db)`` from x (..., D), weight (D,), the saved fp32
    statistics (M,) and dy (..., D) in any layout. dx in x's dtype; dw, db
    in the weight's. The same inputs give the same bits (no atomics)."""
    if x.device.type == "cpu":
        return layer_norm_backward_reference(x, weight, mean, rstd, dy)
    dy = dy.contiguous()
    rows, d = _check("fused_layer_norm_bwd", x, weight, None,
                     (("mean", mean), ("rstd", rstd), ("dy", dy)))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.data_ptr() % 16:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype} (16-byte aligned)")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({rows},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    plan = bwd_plan(rows, d)
    part = torch.empty((2, plan.chunks, d), dtype=torch.float32,
                       device=x.device)
    rc = build.library().tae_layer_norm_bwd(
        x.data_ptr(), weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part.data_ptr(), rows, d, plan.chunks, plan.rows_per_chunk,
        build.dtype_code(x.dtype),
        build.dtype_code(weight.dtype), _stream(x))
    build.check(rc, "tae_layer_norm_bwd")
    fused_layer_norm_bwd.launches += 1
    return dx, dw, db


fused_layer_norm_bwd.launches = 0


class FusedLayerNormFn(torch.autograd.Function):
    """LayerNorm with the kernels in both directions. On a CPU tensor both
    run the plain versions: the explicit backward formula, not autograd of
    the forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = fused_layer_norm_fwd_stats(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = fused_layer_norm_bwd(x, weight, mean, rstd, dy)
        return dx, dw, db, None
