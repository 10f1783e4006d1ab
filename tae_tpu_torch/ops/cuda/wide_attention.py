"""K6-K9: packed-qkv attention for tiny token counts and with int8 output
(counterparts of ``tae_tpu/ops/pallas/flash_attention.py``::
``fused_qkv_attention_wide``, ``fused_qkv_attention_q8``,
``fused_qkv_attention_wide_q8`` and ``fused_qkv_attention_wide_q8_2d``;
source ``tae_tpu_torch/csrc/wide_attention.cu``) and their plain versions.

The four entries keep the JAX entries' argument order and layouts, without
``block_b`` and ``interpret``. K6, K9 and the float32 forms run on the
flat-row body, which works on 16 consecutive rows of the flat (B*N, 3C)
token axis: in bfloat16 a block takes a few heads, a warp each, and with the
int8 output the head groups of one row tile share the row scale over a
thread-block cluster (:func:`rows_plan`). K7 and K8 in bfloat16 from
:data:`Q8_MIN_TOKENS` tokens and up to 32 heads run on the per-image
attention forward body of ``csrc/flash_attention.cu`` (K2's), whose int8 row
epilogue is shared over a thread-block cluster too (:func:`q8_plan`); there
the 3D int8 entry and the flat 2D one (K9, always the flat-row body) are no
longer the same computation, and agree within the int8 tolerances.

The int8 output is the proj matmul's prequantized input: per token one
scale over all heads' fp32 output, ``s = max(max|o| / 127, 1e-12)``, codes
``clip(round_half_even(o * (1 / s)), -127, 127)``. The codes come from the
fp32 output, not from its rounding to the input dtype. These entries exist
in the serving form (clamped softmax) only, and they are forward-only:
given a tensor that requires a gradient they raise.

K6 in the exact form carries a gradient (:class:`WideAttentionFn`): the
forward is the kernel, the backward differentiates the plain attention
reference at the saved qkv. That is the JAX package's own design
(``_wide_vjp_bwd``: the TPU has no backward kernel for tiny token counts
either), not a fallback: no kernel exists to fall back from.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.flash_attention import (HEAD_DIMS, MAX_TOKENS,
                                                    _split,
                                                    packed_attention_f32)

#: tokens per image the wide entries take (every registered tiny-N config)
WIDE_MAX_TOKENS = 64
#: Fewest tokens per image at which K7 and K8 in bfloat16 run on the
#: per-image forward body (``tae::q8::kMinTokens`` in
#: ``csrc/attention_q8.cuh``); below it a per-image block pads its 16-row
#: tiles, and the flat-row body keeps them.
Q8_MIN_TOKENS = 16
#: most blocks of one thread-block cluster (``tae::q8::kMaxCluster``)
Q8_MAX_CLUSTER = 16
#: heads a block of the cluster takes (``tae::q8::kHeadsPerBlock``), so the
#: per-image body takes up to 32 heads
Q8_HEADS_PER_BLOCK = 2
#: The flat-row body's bfloat16 plan (``csrc/rows_attention.cuh``): a
#: block takes ``ROWS_TILE`` flat rows and ``ROWS_HEADS_PER_BLOCK`` heads, a
#: warp each; with the int8 output the blocks of one row tile form a cluster
#: of up to ``ROWS_MAX_CLUSTER``, taking more heads a block where those do
#: not cover them, up to ``ROWS_MAX_HEADS_PER_BLOCK``; keys are staged in
#: chunks of up to ``ROWS_MAX_CHUNK``.
ROWS_TILE = 16
ROWS_HEADS_PER_BLOCK = 4
ROWS_MAX_CLUSTER = 16
ROWS_MAX_HEADS_PER_BLOCK = 8
ROWS_MAX_CHUNK = 64
#: most heads the flat-row body's bfloat16 int8 form takes
ROWS_Q8_MAX_HEADS = ROWS_MAX_CLUSTER * ROWS_MAX_HEADS_PER_BLOCK
#: widest output the flat-row body's float32 int8 form takes on CUDA: a
#: block keeps 16 fp32 output rows in shared memory
ROWS_Q8_MAX_WIDTH = 3072
#: dynamic shared memory of one block on the H100
SMEM_LIMIT = 232448
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Q8Plan:
    """Launch shape of K7 / K8 on the per-image body: ``cluster`` blocks of
    one (image, row tile) along grid.y, each taking ``heads_per_block``
    heads (the last rank fewer), ``warps`` warps of 16 query rows, ``smem``
    bytes of dynamic shared memory."""
    cluster: int
    heads_per_block: int
    warps: int
    smem: int


def q8_plan(n: int, num_heads: int, dh: int,
            dtype: torch.dtype = torch.bfloat16) -> Q8Plan | None:
    """The plan ``tae::q8::plan`` computes for K7 / K8, or None where the
    flat-row body runs them (float32, fewer than :data:`Q8_MIN_TOKENS`
    tokens, more heads than :data:`Q8_MAX_CLUSTER` blocks of
    :data:`Q8_HEADS_PER_BLOCK` take, or a block beyond :data:`SMEM_LIMIT`).

    heads_per_block = min(H, Q8_HEADS_PER_BLOCK), cluster = ceil(H /
    heads_per_block); shared memory: the head's K and V in bf16 (rows of
    dh + 8, tokens padded to 16), the fp32 o of every head of a block but
    the last (one row of dh + 8 per query row) and one partial max per
    query row."""
    if (dtype != torch.bfloat16 or not Q8_MIN_TOKENS <= n <= MAX_TOKENS
            or dh not in HEAD_DIMS
            or not 1 <= num_heads <= Q8_HEADS_PER_BLOCK * Q8_MAX_CLUSTER):
        return None
    hpb = min(num_heads, Q8_HEADS_PER_BLOCK)
    cluster = -(-num_heads // hpb)
    tokens = -(-n // 16) * 16
    warps = min(tokens // 16, 8)
    rows = 16 * warps
    smem = (4 * tokens * (dh + 8) + 4 * (Q8_HEADS_PER_BLOCK - 1) * rows
            * (dh + 8) + 4 * rows)
    return Q8Plan(cluster, hpb, warps, smem) if smem <= SMEM_LIMIT else None


def q8_plan_of_library(n: int, num_heads: int, dh: int
                       ) -> tuple[Q8Plan | None, int]:
    """(the built library's plan for bf16 (n, H, dh), the clusters of that
    shape the card holds at once; 0 where the body does not take it): what
    ``chip_smoke.py`` holds :func:`q8_plan` against. Needs the card."""
    out = (ctypes.c_int * 6)()
    build.check(build.library().tae_attention_q8_plan(n, num_heads, dh, out),
                "tae_attention_q8_plan")
    if not out[0]:
        return None, 0
    return Q8Plan(*out[1:5]), out[5]


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """Launch shape of the flat-row body in bfloat16: ``groups`` blocks of
    ``heads_per_block`` heads (a warp each; the last group fewer) along
    grid.y for each 16-row tile, ``cluster`` of them in one thread-block
    cluster (the int8 output; else 1), keys staged ``chunk`` at a time,
    ``smem`` bytes of dynamic shared memory."""
    cluster: int
    groups: int
    heads_per_block: int
    chunk: int
    smem: int


def rows_chunk(n: int) -> int:
    """Keys per staged chunk for ``n`` tokens per image
    (``tae::rows::chunk_for``): the widest key range a 16-row tile sees
    (16 / n whole images, one image, or parts of up to 15 // n + 2 images),
    padded to 16, up to :data:`ROWS_MAX_CHUNK`."""
    span = (ROWS_TILE if ROWS_TILE % n == 0 else n if n % ROWS_TILE == 0
            else n * (15 // n + 2))
    return min(-(-span // 16) * 16, ROWS_MAX_CHUNK)


def rows_plan(n: int, num_heads: int, dh: int, q8: bool) -> RowsPlan | None:
    """The plan ``tae::rows::plan`` computes for the bfloat16 flat-row body
    with the int8 output (``q8``: K9, and K7 / K8 where they run there) or a
    bfloat16 one (K6), or None where it does not take the shape (tokens
    outside 1..256, another head dim, more heads than its grid or, with the
    int8 output, than :data:`ROWS_Q8_MAX_HEADS`).

    heads_per_block = min(H, ROWS_HEADS_PER_BLOCK), raised to ceil(H /
    ROWS_MAX_CLUSTER) with the int8 output; groups = ceil(H /
    heads_per_block), all in one cluster with the int8 output; shared
    memory: per warp the Q tile and a chunk of K and V in bf16 rows of dh +
    8, and with the int8 output one fp32 max per warp and row and one per
    row for the block."""
    if not 1 <= n <= MAX_TOKENS or dh not in HEAD_DIMS or not 1 <= num_heads <= 65535:
        return None
    hpb = min(num_heads, ROWS_HEADS_PER_BLOCK)
    if q8:
        hpb = max(hpb, -(-num_heads // ROWS_MAX_CLUSTER))
        if hpb > ROWS_MAX_HEADS_PER_BLOCK:
            return None
    groups = -(-num_heads // hpb)
    chunk = rows_chunk(n)
    smem = (hpb * (ROWS_TILE + 2 * chunk) * (dh + 8) * 2
            + (4 * ROWS_TILE * (hpb + 1) if q8 else 0))
    return RowsPlan(groups if q8 else 1, groups, hpb, chunk, smem)


def rows_plan_of_library(n: int, num_heads: int, dh: int, q8: bool
                         ) -> tuple[RowsPlan | None, int]:
    """(the built library's flat-row plan for bf16 (n, H, dh), the clusters
    (``q8``) or blocks of that shape the card holds at once; 0 where the
    body does not take it): what ``chip_smoke.py`` holds :func:`rows_plan`
    against. Needs the card."""
    out = (ctypes.c_int * 7)()
    build.check(build.library().tae_rows_attention_plan(n, num_heads, dh,
                                                        int(q8), out),
                "tae_rows_attention_plan")
    if not out[0]:
        return None, 0
    return RowsPlan(*out[1:6]), out[6]


def check_q8_width(name: str, n: int, num_heads: int, dh: int,
                   dtype: torch.dtype) -> None:
    """Raise where neither body takes the int8 output on CUDA: in bfloat16
    the per-image body up to 32 heads from 16 tokens, the flat-row body up
    to :data:`ROWS_Q8_MAX_HEADS` heads at any width; in float32 the
    flat-row body up to :data:`ROWS_Q8_MAX_WIDTH` columns."""
    width = num_heads * dh
    if dtype == torch.bfloat16:
        if (q8_plan(n, num_heads, dh, dtype) is None
                and rows_plan(n, num_heads, dh, q8=True) is None):
            raise ValueError(
                f"{name} takes up to {ROWS_Q8_MAX_HEADS} heads in bfloat16 "
                f"({n} tokens, {num_heads} heads of {dh}: output width "
                f"{width})")
    elif width > ROWS_Q8_MAX_WIDTH:
        raise ValueError(
            f"{name} takes an output width up to {ROWS_Q8_MAX_WIDTH} in "
            f"{dtype} ({n} tokens, {num_heads} heads of {dh}), got {width}")


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
    if q8:
        check_q8_width(name, n, num_heads, dh, qkv.dtype)
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
    bfloat16, contiguous, head dim 64 or 80; anything else raises. The exact
    form is differentiable (:class:`WideAttentionFn`); the serving form is
    forward-only and raises where autograd records through qkv."""
    b, n, c, dh = _split(qkv, num_heads)
    _check_wide("fused_qkv_attention_wide", n)
    if scale is None:
        scale = dh ** -0.5
    if serving:
        build.refuse_grad("fused_qkv_attention_wide(serving=True)", qkv)
    elif build.needs_grad(qkv):
        return WideAttentionFn.apply(qkv, num_heads, float(scale))
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


def wide_attention_backward_reference(qkv: torch.Tensor, do: torch.Tensor,
                                      num_heads: int, scale: float
                                      ) -> torch.Tensor:
    """dqkv of the wide entry: autograd of the plain attention reference
    (:func:`tae_tpu_torch.ops.attention.attention_reference`) at qkv, the
    counterpart of the JAX package's ``_wide_vjp_bwd``."""
    from tae_tpu_torch.ops.attention import attention_reference

    b, n, c, dh = _split(qkv, num_heads)
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        r = x.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
        y = attention_reference(r[0], r[1], r[2], scale)
        y = y.transpose(1, 2).reshape(b, n, c)
        (dqkv,) = torch.autograd.grad(y, x, do.to(y.dtype))
    return dqkv


class WideAttentionFn(torch.autograd.Function):
    """K6 with a gradient: the forward is the kernel in its exact form (the
    plain version on a CPU tensor), the backward plain PyTorch on whatever
    device qkv lies on, by design (see the module docstring)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return fused_qkv_attention_wide(qkv.detach(), num_heads, scale,
                                        serving=False)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return (wide_attention_backward_reference(qkv, do, ctx.num_heads,
                                                  ctx.scale), None, None)


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
    build.refuse_grad("fused_qkv_attention_q8", qkv)
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
    build.refuse_grad("fused_qkv_attention_wide_q8", qkv)
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
    build.refuse_grad("fused_qkv_attention_wide_q8_2d", qkv2)
    if scale is None:
        scale = dh ** -0.5
    if qkv2.device.type == "cpu":
        return fused_qkv_attention_wide_q8_2d_reference(qkv2, n, num_heads,
                                                        scale)
    return _launch_q8("tae_wide_attention_q8_2d_fwd",
                      fused_qkv_attention_wide_q8_2d, qkv2, (rows,), n,
                      num_heads, dh, scale, rows)


fused_qkv_attention_wide_q8_2d.launches = 0
