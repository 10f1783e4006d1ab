"""Attention kernels of ``tae_tpu/ops/pallas/flash_attention.py`` (sources
``tae_tpu_torch/csrc/flash_attention.cu`` and ``flash_attention_bwd.cu``) and
their plain versions:

  * K2 and K10, packed-qkv attention forward and backward (counterparts of
    ``fused_qkv_attention`` and its VJP, ``_packed_vjp_fwd`` /
    ``_packed_vjp_bwd``). :func:`fused_qkv_attention` is the entry. Where
    autograd records through qkv it runs as :class:`FusedQKVAttentionFn`:
    the exact-softmax forward that also saves the log-sum-exp of every score
    row (:func:`fused_qkv_attention_fwd_lse`) and the backward kernel
    (:func:`fused_qkv_attention_bwd`). The serving form (clamped softmax) is
    forward-only and raises there.
  * K16 and K17, attention on unpacked q, k, v (B, H, N, dh) (counterparts of
    ``flash_attention`` and its custom VJP, the qk_norm block's attention):
    :func:`flash_attention` is the entry, :class:`FlashAttentionFn` carries
    :func:`flash_attention_fwd_lse` and :func:`flash_attention_bwd`. Exact
    softmax only: the JAX kernel has no serving form. The operands are read
    where they lie, with their strides (the last axis contiguous).
  * K15, the int8-input attention (``fused_qkv_attention_i8``):
    :func:`fused_qkv_attention_i8` on K4's ``q8_out`` output, forward only.

The launch counts are kept apart.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tae_tpu_torch.ops.cuda import build

#: tokens and head dims the kernel takes (every registered TAE config)
MAX_TOKENS = 256
HEAD_DIMS = (64, 80)
#: the serving softmax's score clamp (tae_tpu _SOFTMAX_CLIP)
SOFTMAX_CLIP = (-60.0, 45.0)
#: tokens from which the fp32 forward runs its register-tiled body
#: (csrc/flash_attention.cu, kF32TiledMinTokens); below, a warp a query row
F32_TILED_MIN_TOKENS = 33
#: tokens from which the fp32 backward (K10, K17) runs its register-tiled
#: body, which forms S and dP once per (query, key) (csrc/
#: flash_attention_bwd.cu, kF32TiledMinTokens); below, the first design
F32_BWD_TILED_MIN_TOKENS = 56
#: keys a chunk of the tiled fp32 backward per head dim (``BwdTiles::KC``)
F32_BWD_CHUNK = {64: 32, 80: 16}
#: dynamic shared memory of one block on the H100
SMEM_LIMIT = 232448
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class BwdF32Plan:
    """Launch of the fp32 attention backward (K10, K17) for one head of n
    tokens: the register-tiled body (``tiled``, ``chunk`` keys a chunk) or
    the first design, ``threads`` a block (one per (image, head)),
    ``smem`` bytes of dynamic shared memory."""
    tiled: bool
    chunk: int
    threads: int
    smem: int


def bwd_f32_plan(n: int, dh: int) -> BwdF32Plan | None:
    """The launch ``tae_attention_bwd_f32_plan`` reports for (n, dh), or
    None where the backward does not take it.

    From :data:`F32_BWD_TILED_MIN_TOKENS` tokens the tiled body: 256
    threads; Q and dO of the head (rows padded to 8, fp32 rows of dh + 4),
    one K and V chunk of :data:`F32_BWD_CHUNK` keys, P and dS of the chunk
    (rows of chunk + 4) and lse and delta a row. Below, the first design: 8
    warps; K and V, then Q and dO, of the head (rows of dh + 4), lse and
    delta (padded to 4), each warp's own two rows and its p and dS rows."""
    if not 1 <= n <= MAX_TOKENS or dh not in HEAD_DIMS:
        return None
    ld = dh + 4
    if n >= F32_BWD_TILED_MIN_TOKENS:
        kc, np_ = F32_BWD_CHUNK[dh], -(-n // 8) * 8
        smem = 4 * (2 * np_ * ld + 2 * kc * ld + 2 * np_ * (kc + 4) + 2 * np_)
        return BwdF32Plan(True, kc, 256, smem)
    smem = 4 * (2 * n * ld + 2 * (-(-n // 4) * 4) + 8 * 2 * ld + 8 * 2 * n)
    return BwdF32Plan(False, 0, 256, smem)


def bwd_f32_plan_of_library(n: int, dh: int) -> BwdF32Plan:
    """The built library's fp32 backward launch for (n, dh): what
    ``chip_smoke.py`` holds :func:`bwd_f32_plan` against. Needs the card's
    build of the kernels."""
    out = (ctypes.c_int * 4)()
    build.check(build.library().tae_attention_bwd_f32_plan(n, dh, out),
                "tae_attention_bwd_f32_plan")
    return BwdF32Plan(bool(out[0]), out[1], out[2], out[3])


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


def _heads(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3C) -> (3, B, H, N, dh) views of q, k, v."""
    b, n, c, dh = _split(qkv, num_heads)
    return qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)


def fused_qkv_attention_lse_reference(qkv: torch.Tensor, num_heads: int,
                                      scale: float | None = None):
    """Plain version of the training forward: ``(o (B, N, C), lse (B, H, N)
    fp32)``. The exact softmax of :func:`packed_attention_f32` (p rounded to
    the input dtype ahead of P·V, the row sum from the fp32 p) with
    ``lse = rowmax + log(rowsum)`` of the scaled scores."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    q, k, v = _heads(qkv, num_heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()) * (1.0 / l)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.transpose(1, 2).reshape(b, n, c).to(qkv.dtype), lse


def fused_qkv_attention_backward_reference(qkv: torch.Tensor, o: torch.Tensor,
                                           lse: torch.Tensor, do: torch.Tensor,
                                           num_heads: int,
                                           scale: float | None = None
                                           ) -> torch.Tensor:
    """Plain version of the backward kernel: dqkv (B, N, 3C) from the packed
    qkv, the saved output o (B, N, C), the saved lse (B, H, N) and the
    output's gradient do (B, N, C). Per (image, head), in fp32::

        S = Q Kᵀ · scale        P = exp(S − lse)       dP = dO Vᵀ
        delta = rowsum(dO ∘ o)  dS = P ∘ (dP − delta) · scale
        dV = Pᵀ dO              dQ = dS K              dK = dSᵀ Q

    ``delta`` takes the saved o, which is rounded to the input dtype. Ahead
    of the last three products P and dS are rounded to the input dtype (dS
    is formed from the fp32 P first), as the tensor cores take them and as
    the forward rounds p ahead of P·V; the operands q, k, v, do are exact
    in fp32. In float32 nothing is rounded. Each output is rounded once."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    dt = qkv.dtype
    q, k, v = (t.float() for t in _heads(qkv, num_heads))

    def heads(t):                                   # (B, N, C) -> (B, H, N, dh)
        return t.reshape(b, n, num_heads, dh).transpose(1, 2).float()

    o4, do4 = heads(o), heads(do)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do4, v.transpose(-1, -2))
    delta = (do4 * o4).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    p_r, ds_r = p.to(dt).float(), ds.to(dt).float()
    dv = torch.matmul(p_r.transpose(-1, -2), do4)
    dq = torch.matmul(ds_r, k)
    dk = torch.matmul(ds_r.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv])                # (3, B, H, N, dh)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, 3 * c).to(dt)


def _check_cuda(name: str, qkv: torch.Tensor, b: int, n: int, num_heads: int,
                dh: int, contiguous: bool = True) -> None:
    """Raise on what the kernels do not take (``contiguous=False``: the
    caller checks the operands' layouts itself)."""
    if not qkv.is_cuda:
        raise ValueError(f"{name} takes CPU or CUDA tensors, not "
                         f"{qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32/bfloat16, got {qkv.dtype}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"{name} takes 1..{MAX_TOKENS} tokens, got {n}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dim in {HEAD_DIMS}, got {dh}")
    if not 1 <= b <= 65535 or num_heads > 65535:
        raise ValueError(f"batch {b} / heads {num_heads} exceed the grid")
    if contiguous and (not qkv.is_contiguous() or qkv.data_ptr() % 16):
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned qkv")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int,
                        scale: float | None = None,
                        serving: bool = True) -> torch.Tensor:
    """(B, N, 3C) packed qkv -> (B, N, C), head split and merge inside the
    kernel. On CUDA: float32 or bfloat16, contiguous, N <= 256, head dim 64
    or 80; anything else raises. The exact form (``serving=False``) is
    differentiable: where autograd records through qkv, the training forward
    and the backward kernel run. The serving form is forward-only and raises
    there."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    if serving:
        build.refuse_grad("fused_qkv_attention(serving=True)", qkv)
    elif build.needs_grad(qkv):
        return FusedQKVAttentionFn.apply(qkv, num_heads, float(scale))
    if qkv.device.type == "cpu":
        return fused_qkv_attention_reference(qkv, num_heads, scale, serving)
    _check_cuda("fused_qkv_attention", qkv, b, n, num_heads, dh)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    rc = build.library().tae_packed_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, dh, float(scale),
        int(bool(serving)), build.dtype_code(qkv.dtype), _stream(qkv))
    build.check(rc, "tae_packed_attention_fwd")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


def fused_qkv_attention_fwd_lse(qkv: torch.Tensor, num_heads: int,
                                scale: float | None = None):
    """The training forward: ``(o (B, N, C), lse (B, H, N) fp32)``, always
    the exact softmax. No gradient of its own: :class:`FusedQKVAttentionFn`
    calls it."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_lse_reference(qkv, num_heads, scale)
    _check_cuda("fused_qkv_attention_fwd_lse", qkv, b, n, num_heads, dh)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32,
                      device=qkv.device)
    rc = build.library().tae_packed_attention_fwd_lse(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, num_heads, dh,
        float(scale), build.dtype_code(qkv.dtype), _stream(qkv))
    build.check(rc, "tae_packed_attention_fwd_lse")
    fused_qkv_attention_fwd_lse.launches += 1
    return out, lse


fused_qkv_attention_fwd_lse.launches = 0


def fused_qkv_attention_bwd(qkv: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            num_heads: int, scale: float | None = None
                            ) -> torch.Tensor:
    """K10: dqkv (B, N, 3C) from qkv, the saved o and lse, and do (B, N, C)
    in any layout. Every element of dqkv is written once; the same inputs
    give the same bits (no atomics)."""
    b, n, c, dh = _split(qkv, num_heads)
    if scale is None:
        scale = dh ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_backward_reference(qkv, o, lse, do,
                                                      num_heads, scale)
    _check_cuda("fused_qkv_attention_bwd", qkv, b, n, num_heads, dh)
    do = do.contiguous()
    dev, dt = qkv.device, (qkv.dtype,)
    build.check_operand("o", o, dev, dt, (b, n, c))
    build.check_operand("do", do, dev, dt, (b, n, c))
    build.check_operand("lse", lse, dev, (torch.float32,), (b, num_heads, n))
    dqkv = torch.empty_like(qkv)
    rc = build.library().tae_packed_attention_bwd(
        qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dqkv.data_ptr(), b, n, num_heads, dh, float(scale),
        build.dtype_code(qkv.dtype), _stream(qkv))
    build.check(rc, "tae_packed_attention_bwd")
    fused_qkv_attention_bwd.launches += 1
    return dqkv


fused_qkv_attention_bwd.launches = 0


class FusedQKVAttentionFn(torch.autograd.Function):
    """Packed-qkv attention with the kernels in both directions; saves qkv,
    o and lse. On a CPU tensor both directions run the plain versions."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        o, lse = fused_qkv_attention_fwd_lse(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        return (fused_qkv_attention_bwd(qkv, o, lse, do, ctx.num_heads,
                                        ctx.scale), None, None)


# ---------------------------------------------------------------------------
# K16 / K17: unpacked q, k, v (B, H, N, dh)
# ---------------------------------------------------------------------------

def _unpacked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not one (B, H, N, dh) shape")
    dh = q.shape[-1]
    return q.shape, (dh ** -0.5 if scale is None else scale)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float | None = None):
    """Plain version of K16 (``_fwd_kernel``): ``(o (B, H, N, dh) in q's
    dtype, lse (B, H, N) fp32)``. fp32 scores of the upcast operands, p =
    exp(s - rowmax), the row sum l of the fp32 p, P·V with p rounded to v's
    dtype, o = (P·V) / l; lse = rowmax + log(l)."""
    _, scale = _unpacked(q, k, v, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_backward_reference(q, k, v, o, lse, do,
                                       scale: float | None = None):
    """Plain version of K17 (``_bwd_kernel``), fp32 throughout as the JAX
    body: every operand upcast, P = exp(S − lse), dV = Pᵀ·dO, dP = dO·Vᵀ,
    δ = rowsum(dO ∘ O), dS = P ∘ (dP − δ) · scale, dQ = dS·K, dK = dSᵀ·Q;
    ``(dq, dk, dv)`` rounded once to q's dtype. (The kernel rounds P and dS
    to bfloat16 ahead of its last three products in bfloat16.)"""
    _, scale = _unpacked(q, k, v, scale)
    q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, o, do))
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    delta = (do32 * o32).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _operands(like: torch.Tensor, named) -> tuple[list, list[int]]:
    """The (B, H, N, dh) operands ``named`` ((name, tensor) pairs) as the
    kernels take them: each where it lies if its last axis is contiguous and
    its rows are 16-byte aligned, else a contiguous copy; and their (image,
    head, row) element strides, flat. Raises on another shape, dtype or
    device than ``like``'s."""
    tensors, strides = [], []
    for name, t in named:
        if t.shape != like.shape or t.dtype != like.dtype \
                or t.device != like.device:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {tuple(like.shape)} "
                             f"{like.dtype} on {like.device}")
        step = 16 // t.element_size()
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(st % step for st in t.stride()[:3])):
            t = t.contiguous()
        tensors.append(t)
        strides += t.stride()[:3]
    return tensors, strides


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """K16: q, k, v (B, H, N, dh) -> o (B, H, N, dh) in q's dtype, the exact
    softmax. On CUDA: float32 or bfloat16, N <= 256, head dim 64 or 80, each
    operand's last axis contiguous (any other strides are read as they
    are); anything else raises. Differentiable: where autograd records
    through q, k or v, :class:`FlashAttentionFn` runs the LSE forward and
    K17."""
    shape, scale = _unpacked(q, k, v, scale)
    if build.needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, float(scale))
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)[0]
    out = _flash_fwd(q, k, v, scale, with_lse=False)[0]
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _flash_fwd(q, k, v, scale: float, with_lse: bool):
    b, h, n, dh = q.shape
    _check_cuda("flash_attention", q, b, n, h, dh, contiguous=False)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    (q, k, v, out), strides = _operands(
        q, (("q", q), ("k", k), ("v", v), ("out", out)))
    rc = build.library().tae_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), build.ptr(lse),
        build.int64_array(strides), b, n, h, dh, float(scale),
        build.dtype_code(q.dtype), _stream(q))
    build.check(rc, "tae_flash_attention_fwd")
    return out, lse


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float | None = None):
    """K16's training form: ``(o, lse (B, H, N) fp32)``. No gradient of its
    own: :class:`FlashAttentionFn` calls it."""
    _, scale = _unpacked(q, k, v, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    out = _flash_fwd(q, k, v, scale, with_lse=True)
    flash_attention_fwd_lse.launches += 1
    return out


flash_attention_fwd_lse.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, scale: float | None = None):
    """K17: ``(dq, dk, dv)`` (B, H, N, dh), contiguous, in q's dtype, from
    q, k, v, the saved o and lse and do. Every element is written once; the
    same inputs give the same bits (no atomics)."""
    shape, scale = _unpacked(q, k, v, scale)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    b, h, n, dh = shape
    _check_cuda("flash_attention_bwd", q, b, n, h, dh, contiguous=False)
    build.check_operand("lse", lse, q.device, (torch.float32,), (b, h, n))
    dq, dk, dv = (torch.empty(shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    (q, k, v, o, do, dq, dk, dv), strides = _operands(
        q, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("dq", dq),
            ("dk", dk), ("dv", dv)))
    rc = build.library().tae_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        build.int64_array(strides), b, n, h, dh, float(scale),
        build.dtype_code(q.dtype), _stream(q))
    build.check(rc, "tae_flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Unpacked attention with K16 (LSE form) forward and K17 backward;
    saves q, k, v, o and lse. On CPU tensors both directions run the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.scale), None)


# ---------------------------------------------------------------------------
# K15: int8 packed qkv with per-(row, column block) scales
# ---------------------------------------------------------------------------

def _i8_block(qkv_q: torch.Tensor, scales: torch.Tensor, num_heads: int):
    b, n, c, dh = _split(qkv_q, num_heads)
    n_nb = scales.shape[0]
    if scales.numel() != n_nb * b * n or (3 * c) % n_nb:
        raise ValueError(f"scales {tuple(scales.shape)} are not (3C / bn, "
                         f"B*N[, 1]) for qkv {tuple(qkv_q.shape)}")
    bn = 3 * c // n_nb
    if bn % dh:
        raise ValueError(f"head dim {dh} must divide the scale block {bn}")
    return b, n, c, dh, bn


def dequantize_qkv(qkv_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 qkv (B, N, 3C) and scales (n_nb, B*N[, 1]) -> bf16 qkv: each
    code times the scale of its row and column block, in fp32, rounded to
    bfloat16 (``_packed_fwd_kernel_stacked_i8``'s ``deq``)."""
    b, n, c3 = qkv_q.shape
    n_nb = scales.shape[0]
    s = scales.reshape(n_nb, b * n).float()
    col = s.repeat_interleave(c3 // n_nb, dim=0).t().reshape(b, n, c3)
    return (qkv_q.float() * col).to(torch.bfloat16)


def fused_qkv_attention_i8_reference(qkv_q: torch.Tensor, scales: torch.Tensor,
                                     num_heads: int,
                                     scale: float | None = None
                                     ) -> torch.Tensor:
    """Plain version of K15: :func:`dequantize_qkv`, then the serving form
    of :func:`fused_qkv_attention_reference`; (B, N, C) bfloat16."""
    _i8_block(qkv_q, scales, num_heads)
    return fused_qkv_attention_reference(dequantize_qkv(qkv_q, scales),
                                         num_heads, scale, serving=True)


def fused_qkv_attention_i8(qkv_q: torch.Tensor, scales: torch.Tensor,
                           num_heads: int,
                           scale: float | None = None) -> torch.Tensor:
    """K15: int8 packed qkv (B, N, 3C) with scales (3C / bn, B*N[, 1]) from
    K4's ``q8_out`` -> (B, N, C) bfloat16, the serving softmax. The head dim
    must divide bn (raises otherwise, as the JAX entry does). On CUDA: N <=
    256, head dim 64 or 80, contiguous operands. Forward only."""
    b, n, c, dh, bn = _i8_block(qkv_q, scales, num_heads)
    if scale is None:
        scale = dh ** -0.5
    if qkv_q.dtype != torch.int8:
        raise TypeError(f"fused_qkv_attention_i8 takes int8 qkv, not "
                        f"{qkv_q.dtype}")
    build.refuse_grad("fused_qkv_attention_i8", scales)
    if qkv_q.device.type == "cpu":
        return fused_qkv_attention_i8_reference(qkv_q, scales, num_heads, scale)
    if not qkv_q.is_cuda:
        raise ValueError(f"fused_qkv_attention_i8 takes CPU or CUDA tensors, "
                         f"not {qkv_q.device}")
    if not 1 <= n <= MAX_TOKENS or dh not in HEAD_DIMS:
        raise ValueError(f"fused_qkv_attention_i8 takes 1..{MAX_TOKENS} tokens "
                         f"and head dim in {HEAD_DIMS}, got {n}, {dh}")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} exceeds the grid")
    build.check_operand("qkv", qkv_q, qkv_q.device, (torch.int8,))
    build.check_operand("scales", scales, qkv_q.device, (torch.float32,))
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=qkv_q.device)
    rc = build.library().tae_qkv_i8_attention_fwd(
        qkv_q.data_ptr(), scales.data_ptr(), out.data_ptr(), b, n, num_heads,
        dh, bn, float(scale), _stream(qkv_q))
    build.check(rc, "tae_qkv_i8_attention_fwd")
    fused_qkv_attention_i8.launches += 1
    return out


fused_qkv_attention_i8.launches = 0
