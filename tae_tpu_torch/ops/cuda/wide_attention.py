"""K6-K9: packed-qkv attention for tiny token counts and with int8 output
(counterparts of ``tae_tpu/ops/pallas/flash_attention.py``::
``fused_qkv_attention_wide``, ``fused_qkv_attention_q8``,
``fused_qkv_attention_wide_q8`` and ``fused_qkv_attention_wide_q8_2d``;
source ``tae_tpu_torch/csrc/wide_attention.cu``) and their plain versions.

The four entries keep the JAX entries' argument order and layouts, without
``block_b`` and ``interpret``. They share one kernel template that works on
16 consecutive rows of the flat (B*N, 3C) token axis, so the 3D and the 2D
int8 entry are the same computation on the same bytes.

The int8 output is the proj matmul's prequantized input: per token one
scale over all heads' fp32 output, ``s = max(max|o| / 127, 1e-12)``, codes
``clip(round_half_even(o * (1 / s)), -127, 127)``. The codes come from the
fp32 output, not from its rounding to the input dtype. These entries exist
in the serving form (clamped softmax) only.
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.flash_attention import (HEAD_DIMS, MAX_TOKENS,
                                                    _split,
                                                    packed_attention_f32)

#: tokens per image the wide entries take (every registered tiny-N config)
WIDE_MAX_TOKENS = 64
#: widest attention output the int8 entries take on CUDA: a block keeps 16
#: fp32 output rows in shared memory beside one warp's K and V
Q8_MAX_WIDTH = 3072
_DTYPES = (torch.float32, torch.bfloat16)


def quantize_attention_rows(o: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of the fp32 attention output o (..., C):
    (int8 (..., C), fp32 scales (..., 1)), a product with the exact
    reciprocal of the scale and round-half-even, as the kernels' epilogue."""
    s = (o.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(o * (1.0 / s)).clamp(-127.0, 127.0).to(torch.int8)
    return q, s


def _check_wide(name: str, n: int) -> None:
    if not 1 <= n <= WIDE_MAX_TOKENS:
        raise ValueError(f"{name} takes 1..{WIDE_MAX_TOKENS} tokens per image, "
                         f"got {n} (above that: fused_qkv_attention / "
                         "fused_qkv_attention_q8)")


def _check_cuda(name: str, qkv: torch.Tensor, n: int, num_heads: int, dh: int,
                q8: bool) -> None:
    """Raise on what the kernels do not take."""
    if not qkv.is_cuda:
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32/bfloat16, got {qkv.dtype}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"{name} takes 1..{MAX_TOKENS} tokens, got {n}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dim in {HEAD_DIMS}, got {dh}")
    if num_heads > 65535 or qkv.shape[0] == 0:
        raise ValueError(f"{name}: {num_heads} heads / an empty batch")
    if q8 and num_heads * dh > Q8_MAX_WIDTH:
        raise ValueError(f"{name} takes an output width up to {Q8_MAX_WIDTH} "
                         f"(16 fp32 rows in shared memory), got {num_heads * dh}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned qkv")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------- K6

def fused_qkv_attention_wide_reference(qkv: torch.Tensor, num_heads: int,
                                       scale: float | None = None,
                                       serving: bool = True) -> torch.Tensor:
    """Plain version: each image on its own, which the kernel's masked tiles
    equal. (B, N, 3C) -> (B, N, C)."""
    return packed_attention_f32(qkv, num_heads, scale, serving).to(qkv.dtype)


def fused_qkv_attention_wide(qkv: torch.Tensor, num_heads: int,
                             scale: float | None = None,
                             serving: bool = True) -> torch.Tensor:
    """(B, N, 3C) packed qkv -> (B, N, C) for N <= 64: 16-row tiles of the
    flat token axis, several images per tile at N < 16. ``serving`` selects
    the clamped softmax, otherwise the exact one. On CUDA: float32 or
    bfloat16, contiguous, head dim 64 or 80; anything else raises."""
    b, n, c, dh = _split(qkv, num_heads)
    _check_wide("fused_qkv_attention_wide", n)
    if scale is None:
        scale = dh ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_wide_reference(qkv, num_heads, scale, serving)
    _check_cuda("fused_qkv_attention_wide", qkv, n, num_heads, dh, q8=False)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    rc = build.library().tae_wide_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, dh, float(scale),
        int(bool(serving)), build.dtype_code(qkv.dtype), _stream(qkv))
    build.check(rc, "tae_wide_attention_fwd")
    fused_qkv_attention_wide.launches += 1
    return out


fused_qkv_attention_wide.launches = 0


# --------------------------------------------------------------------- K7

def fused_qkv_attention_q8_reference(qkv: torch.Tensor, num_heads: int,
                                     scale: float | None = None):
    """Plain version: (B, N, 3C) -> (int8 (B, N, C), fp32 (B, N, 1))."""
    return quantize_attention_rows(
        packed_attention_f32(qkv, num_heads, scale, serving=True))


def _launch_q8(entry: str, wrapper, qkv: torch.Tensor, lead: tuple, n: int,
               num_heads: int, dh: int, scale: float, *sizes: int):
    """Allocate the int8 output and scales of shape ``lead + (C or 1,)`` and
    launch C entry point ``entry`` with the leading ``sizes``."""
    c = num_heads * dh
    _check_cuda(wrapper.__name__, qkv, n, num_heads, dh, q8=True)
    out_q = torch.empty((*lead, c), dtype=torch.int8, device=qkv.device)
    out_s = torch.empty((*lead, 1), dtype=torch.float32, device=qkv.device)
    rc = getattr(build.library(), entry)(
        qkv.data_ptr(), out_q.data_ptr(), out_s.data_ptr(), *sizes, n,
        num_heads, dh, float(scale), build.dtype_code(qkv.dtype), _stream(qkv))
    build.check(rc, entry)
    wrapper.launches += 1
    return out_q, out_s


def fused_qkv_attention_q8(qkv: torch.Tensor, num_heads: int,
                           scale: float | None = None):
    """(B, N, 3C) packed qkv -> (int8 (B, N, C) attention output, fp32
    (B, N, 1) per-row scales), serving softmax, N <= 256."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_q8_reference(qkv, num_heads, scale)
    return _launch_q8("tae_packed_attention_q8_fwd", fused_qkv_attention_q8,
                      qkv, (b, n), n, num_heads, dh, scale, b)


fused_qkv_attention_q8.launches = 0


# --------------------------------------------------------------------- K8

def fused_qkv_attention_wide_q8_reference(qkv: torch.Tensor, num_heads: int,
                                          scale: float | None = None):
    """Plain version: each image on its own. (B, N, 3C) -> (int8 (B, N, C),
    fp32 (B, N, 1))."""
    return fused_qkv_attention_q8_reference(qkv, num_heads, scale)


def fused_qkv_attention_wide_q8(qkv: torch.Tensor, num_heads: int,
                                scale: float | None = None):
    """Wide (N <= 64) counterpart of :func:`fused_qkv_attention_q8`."""
    b, n, c, dh = _split(qkv, num_heads)
    _check_wide("fused_qkv_attention_wide_q8", n)
    if scale is None:
        scale = dh ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_wide_q8_reference(qkv, num_heads, scale)
    return _launch_q8("tae_wide_attention_q8_fwd", fused_qkv_attention_wide_q8,
                      qkv, (b, n), n, num_heads, dh, scale, b)


fused_qkv_attention_wide_q8.launches = 0


# --------------------------------------------------------------------- K9

def _split_2d(qkv2: torch.Tensor, n: int, num_heads: int):
    if qkv2.ndim != 2 or n < 1 or qkv2.shape[0] % n:
        raise ValueError(f"qkv2 {tuple(qkv2.shape)} is not (B * {n}, 3C) rows")
    rows = qkv2.shape[0]
    return rows, _split(qkv2.reshape(rows // n, n, -1), num_heads)[3]


def fused_qkv_attention_wide_q8_2d_reference(qkv2: torch.Tensor, n: int,
                                             num_heads: int,
                                             scale: float | None = None):
    """Plain version: (B*N, 3C) -> (int8 (B*N, C), fp32 (B*N, 1))."""
    rows, _ = _split_2d(qkv2, n, num_heads)
    q, s = fused_qkv_attention_q8_reference(
        qkv2.reshape(rows // n, n, -1), num_heads, scale)
    return q.reshape(rows, -1), s.reshape(rows, 1)


def fused_qkv_attention_wide_q8_2d(qkv2: torch.Tensor, n: int, num_heads: int,
                                   scale: float | None = None):
    """:func:`fused_qkv_attention_wide_q8` on the flat serving layout:
    ``qkv2`` is (B*N, 3C) as the qkv matmul emits it, the outputs (B*N, C)
    int8 and (B*N, 1) scales as the proj matmul reads them."""
    rows, dh = _split_2d(qkv2, n, num_heads)
    _check_wide("fused_qkv_attention_wide_q8_2d", n)
    if scale is None:
        scale = dh ** -0.5
    if qkv2.device.type == "cpu":
        return fused_qkv_attention_wide_q8_2d_reference(qkv2, n, num_heads,
                                                        scale)
    return _launch_q8("tae_wide_attention_q8_2d_fwd",
                      fused_qkv_attention_wide_q8_2d, qkv2, (rows,), n,
                      num_heads, dh, scale, rows)


fused_qkv_attention_wide_q8_2d.launches = 0
