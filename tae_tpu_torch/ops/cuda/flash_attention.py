"""K2: packed-qkv attention forward (counterpart of
``tae_tpu/ops/pallas/flash_attention.py::fused_qkv_attention``; source
``tae_tpu_torch/csrc/flash_attention.cu``) and its plain version."""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import build

#: tokens and head dims the kernel takes (every registered TAE config)
MAX_TOKENS = 256
HEAD_DIMS = (64, 80)
#: the serving softmax's score clamp (tae_tpu _SOFTMAX_CLIP)
SOFTMAX_CLIP = (-60.0, 45.0)
_DTYPES = (torch.float32, torch.bfloat16)


def _split(qkv: torch.Tensor, num_heads: int):
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % num_heads:
        raise ValueError(f"qkv width {c3} does not split into 3 x "
                         f"{num_heads} heads")
    return b, n, c, c // num_heads


def packed_attention_f32(qkv: torch.Tensor, num_heads: int,
                         scale: float | None = None,
                         serving: bool = True) -> torch.Tensor:
    """The arithmetic every packed-qkv attention entry shares, in plain
    PyTorch: (B, N, 3C) -> the fp32 output (B, N, C) before its last
    rounding.

    fp32 scores (operands upcast, so bf16 products are exact); ``serving``
    takes p = exp(clip(s, -60, 45)) with no row max (tae_tpu
    ``_serving_softmax``), otherwise p = exp(s - rowmax). The row sum uses
    the fp32 p, the P·V product p rounded to the input dtype, and the
    output is (P·V) * (1 / l)."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    r = qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = r[0].float(), r[1].float(), r[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale      # (B, H, N, N)
    if serving:
        p = torch.exp(s.clamp(*SOFTMAX_CLIP))
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l_inv = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()) * l_inv
    return o.transpose(1, 2).reshape(b, n, c)


def fused_qkv_attention_reference(qkv: torch.Tensor, num_heads: int,
                                  scale: float | None = None,
                                  serving: bool = True) -> torch.Tensor:
    """Plain version of the kernel: (B, N, 3C) -> (B, N, C), the fp32
    output of :func:`packed_attention_f32` cast once to the input dtype."""
    return packed_attention_f32(qkv, num_heads, scale, serving).to(qkv.dtype)


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int,
                        scale: float | None = None,
                        serving: bool = True) -> torch.Tensor:
    """(B, N, 3C) packed qkv -> (B, N, C), head split and merge inside the
    kernel. On CUDA: float32 or bfloat16, contiguous, N <= 256, head dim 64
    or 80; anything else raises."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_reference(qkv, num_heads, scale, serving)
    if not qkv.is_cuda:
        raise ValueError(f"fused_qkv_attention takes CPU or CUDA tensors, not "
                         f"{qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"fused_qkv_attention takes float32/bfloat16, got "
                        f"{qkv.dtype}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"fused_qkv_attention takes 1..{MAX_TOKENS} tokens, "
                         f"got {n}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"fused_qkv_attention takes head dim in {HEAD_DIMS}, "
                         f"got {dh}")
    if not 1 <= b <= 65535 or num_heads > 65535:
        raise ValueError(f"batch {b} / heads {num_heads} exceed the grid")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("fused_qkv_attention needs a contiguous, 16-byte "
                         "aligned qkv")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    rc = build.library().tae_packed_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, dh, float(scale),
        int(bool(serving)), build.dtype_code(qkv.dtype),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    build.check(rc, "tae_packed_attention_fwd")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
