"""K1 and K11: fused LayerNorm forward and backward (counterparts of
``tae_tpu/ops/pallas/layernorm.py``::``fused_layer_norm`` and its VJP,
``_fln_fwd`` / ``_fln_bwd``; source ``tae_tpu_torch/csrc/layernorm.cu``).

:func:`fused_layer_norm` is the entry. Where autograd records, it runs as
:class:`FusedLayerNormFn`: the forward that also saves each row's mean and
rstd (:func:`fused_layer_norm_fwd_stats`) and the backward kernel
(:func:`fused_layer_norm_bwd`). Otherwise it is the inference forward, which
writes y only. The three launch counts are kept apart, so a serving run
shows no training launch and the reverse.
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.layernorm import (layer_norm_backward_reference,
                                         layer_norm_reference,
                                         layer_norm_stats_reference)

_DTYPES = (torch.float32, torch.bfloat16)
#: rows per partial sum of dw / db in the backward (more for very many rows,
#: so that the partial sums stay within MAX_ROW_CHUNKS)
BWD_ROWS_PER_CHUNK = 128
MAX_ROW_CHUNKS = 1024


def bwd_row_chunks(rows: int) -> tuple[int, int]:
    """``(chunks, rows per chunk)`` of the backward's partial column sums."""
    per = max(BWD_ROWS_PER_CHUNK, -(-rows // MAX_ROW_CHUNKS))
    return -(-rows // per), per


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
    if x.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned x")
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
    both bfloat16. D must be a multiple of 8 on CUDA. Differentiable: where
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
    chunks, per = bwd_row_chunks(rows)
    part = torch.empty((2, chunks, d), dtype=torch.float32, device=x.device)
    rc = build.library().tae_layer_norm_bwd(
        x.data_ptr(), weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part.data_ptr(), rows, d, chunks, per, build.dtype_code(x.dtype),
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
