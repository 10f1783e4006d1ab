"""K3 ``ln_quant`` and K5 ``int8_mlp``: the fused kernels of the int8 serving
block (counterparts of ``tae_tpu/ops/pallas/int8_block.py::ln_quant`` and
``::int8_mlp``; source ``tae_tpu_torch/csrc/int8_block.cu``) and their plain
versions.

``block_h`` is part of ``int8_mlp``'s numerics, not a tuning knob: the hidden
activation gets one int8 scale per (row, block of ``block_h`` hidden
columns), so another ``block_h`` gives other outputs. The kernel and the
plain version take the same explicit value; :data:`DEFAULT_BLOCK_H` is the
one the serving path uses.

``int8_mlp`` is three device launches a call (the fc1 product with its
GELU and requantize epilogue, the fc2 product, a finish pass with the
residual and ``ln_next``), counted as one launch; :func:`mlp_fc1_reference`,
:func:`mlp_fc2_reference` and :func:`mlp_finish_reference` are their plain
versions and compose into :func:`int8_mlp_reference`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.int8_matmul import int_matmul, ln_quant_rows
from tae_tpu_torch.ops.cuda.layernorm import nv_for

_FLOATS = (torch.float32, torch.bfloat16)
#: hidden columns that share one activation scale per row. 256 is two of the
#: kernel's 128-column tiles: fine enough that the per-block scales are
#: tighter than one scale over the whole hidden dim, wide enough that the
#: fc2 partial product of a block has a K of 256 to run over. It divides
#: the hidden dim of every registered config.
DEFAULT_BLOCK_H = 256
_GELU_C = math.sqrt(2.0 / math.pi)


# ---------------------------------------------------------------------------
# K3: LayerNorm -> int8
# ---------------------------------------------------------------------------

def ln_quant_reference(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-6
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (M, D) float -> (int8 LayerNorm(x), (M, 1) f32
    per-row scales)."""
    return ln_quant_rows(x.float(), weight, bias, eps)


#: K3's plan (csrc/row_norm.cuh): the row in registers up to LNQ_MAX_NV
#: 8-column groups a lane (4096 columns), wider rows through the first
#: design's runtime loop; LNQ_MAX_WARPS warps (rows) a block, halved while
#: the grid would have fewer than LNQ_MIN_BLOCKS blocks
LNQ_MAX_NV = 16
LNQ_MAX_WARPS = 4
LNQ_MIN_BLOCKS = 64


@dataclasses.dataclass(frozen=True)
class LnQuantPlan:
    """K3's launch: ``nv`` 8-column groups a lane holds (0: the first
    design's runtime loop), ``warps`` rows a block, ``blocks``."""
    nv: int
    warps: int
    blocks: int


def ln_quant_plan(rows: int, cols: int) -> LnQuantPlan | None:
    """The plan ``tae::rownorm::ln_quant_plan`` computes, or None where the
    kernel does not take the shape (no rows, a width that is not a multiple
    of 8)."""
    if rows < 1 or cols < 8 or cols % 8:
        return None
    warps = LNQ_MAX_WARPS
    while warps > 1 and rows < warps * LNQ_MIN_BLOCKS:
        warps //= 2
    return LnQuantPlan(nv_for(cols, LNQ_MAX_NV), warps, -(-rows // warps))


def ln_quant_plan_of_library(rows: int, cols: int) -> LnQuantPlan | None:
    """The built library's K3 plan for (rows, cols): what ``chip_smoke.py``
    holds :func:`ln_quant_plan` against. Needs the card's build."""
    out = (ctypes.c_int * 4)()
    build.check(build.library().tae_ln_quant_plan(rows, cols, out),
                "tae_ln_quant_plan")
    return LnQuantPlan(*out[1:4]) if out[0] else None


def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, D) float32 / bfloat16 -> (M, D) int8 codes of LayerNorm(x) and
    (M, 1) float32 scales. On CUDA: D a multiple of 8, contiguous inputs,
    weight and bias (D,) of one float dtype; anything else raises."""
    if x.ndim != 2:
        raise ValueError(f"ln_quant takes (M, D) rows, got {tuple(x.shape)}")
    build.refuse_grad("ln_quant", x, weight, bias)
    if x.device.type == "cpu":
        return ln_quant_reference(x, weight, bias, eps)
    if not x.is_cuda:
        raise ValueError(f"ln_quant takes CPU or CUDA tensors, not {x.device}")
    m, d = x.shape
    if d % 8 or d < 8:
        raise ValueError(f"ln_quant needs D a multiple of 8, got {d}")
    if m >= 2 ** 31:
        raise ValueError(f"ln_quant takes < 2**31 rows, got {m}")
    build.check_operand("x", x, x.device, _FLOATS)
    build.check_operand("weight", weight, x.device, _FLOATS, (d,))
    build.check_operand("bias", bias, x.device, (weight.dtype,), (d,))
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, s
    rc = build.library().tae_ln_quant_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), q.data_ptr(),
        s.data_ptr(), m, d, float(eps), build.dtype_code(x.dtype),
        build.dtype_code(weight.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "tae_ln_quant_fwd")
    ln_quant.launches += 1
    return q, s


ln_quant.launches = 0


# ---------------------------------------------------------------------------
# K5: fc1 -> GELU -> requantize -> fc2 + residual
# ---------------------------------------------------------------------------

def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU with the operation order of ``jax.nn.gelu(approximate=
    True)``: ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))``."""
    inner = _GELU_C * (h + 0.044715 * (h * h * h))
    return h * (0.5 * (1.0 + torch.tanh(inner)))


#: fc1's tiles (rows, columns: one hidden block), in the order of
#: csrc/int8_block.cu's kFc1Bh128, kFc1Bh128Few, kFc1Bh256, kFc1Bh256Few,
#: kFc1Bh512Few
FC1_TILES = ((128, 128), (16, 128), (64, 256), (16, 256), (16, 512))
#: fc2's tiles (rows, columns): kFc2Large, kFc2Mid, kFc2Few
FC2_TILES = ((64, 128), (64, 64), (16, 64))


def mlp_tiles(m: int, d: int, hdim: int, block_h: int,
              sms: int) -> tuple[int, int, int]:
    """(fc1 tile, fc2 tile, hidden groups) of the kernel for M rows: indices
    into :data:`FC1_TILES` and :data:`FC2_TILES`, and fc2's split of the
    hidden blocks (:func:`mlp_hidden_groups` of its output tiles).

    fc1's tile is one hidden block wide, so ``block_h`` is 128, 256 or 512
    (wider ones exceed a block's shared memory at 16 rows): 16 rows up to
    M = 64, else 128 rows (64 at ``block_h`` 256). fc2 takes 64 x 128 tiles
    where they fill the ``sms`` SMs, 64 x 64 from 65 rows on otherwise, 16 x
    64 below. Raises on shapes the kernel does not take."""
    if block_h < 128 or block_h % 128 or hdim % block_h:
        raise ValueError(f"int8_mlp needs block_h a multiple of 128 that "
                         f"divides the hidden dim, got block_h={block_h}, "
                         f"hidden={hdim}")
    if d % 16 or d < 16:
        raise ValueError(f"int8_mlp needs D a multiple of 16, got {d}")
    if block_h > 512:
        raise ValueError(f"int8_mlp does not take block_h={block_h}: its fc1 "
                         "tile is one hidden block wide, and 16 rows of one "
                         "wider than 512 exceed a block's shared memory")
    if block_h == 384:
        raise ValueError("int8_mlp takes block_h 128, 256 or 512 (its fc1 "
                         "tile is one hidden block wide), not 384")
    blocks = hdim // block_h
    if block_h == 128:
        fc1 = 0 if m > 64 else 1
    elif block_h == 256:
        fc1 = 3 if m <= 64 else 2
    else:
        fc1 = 4
    big = -(-m // FC2_TILES[0][0]) * -(-d // FC2_TILES[0][1])
    fc2 = 2 if m <= 64 else (0 if big >= sms else 1)
    bm, bn = FC2_TILES[fc2]
    groups = mlp_hidden_groups(-(-m // bm) * -(-d // bn), blocks, sms)
    return fc1, fc2, groups


def mlp_hidden_groups(row_blocks: int, hidden_blocks: int, sms: int) -> int:
    """Groups the kernels split the hidden blocks into. K5's fc2 (and K13)
    launch ``row_blocks`` output tiles (blocks) without a split, and few
    rows leave most SMs idle, so the hidden blocks are dealt evenly to as
    many groups as keep ``row_blocks * groups`` within the card's ``sms``:
    each group sums its fc2 partials in fp32 and the finish pass adds the
    groups in order. 1 (no split) from half the SMs' worth of blocks on.
    The fp32 summation order, and so the last bit of a sum, follows the
    group count."""
    return max(g for g in range(1, hidden_blocks + 1)
               if hidden_blocks % g == 0 and (g == 1 or row_blocks * g <= sms))


def mlp_fc1_reference(xq: torch.Tensor, sx: torch.Tensor,
                      w1_q: torch.Tensor, w1_scale: torch.Tensor,
                      b1: torch.Tensor, block_h: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fc1 product and its epilogue: per hidden block
    of ``block_h`` columns ``h = gelu(float(xq . w1^T) * sx * sw1 + b1)``,
    one scale per row over the block, the int8 codes. Returns (hq (M, H)
    int8, sh (H / block_h, M) fp32)."""
    hdim = w1_q.shape[0]
    if block_h < 1 or hdim % block_h:
        raise ValueError(f"hidden dim {hdim} is not a multiple of block_h "
                         f"{block_h}")
    sx = sx.reshape(-1, 1)
    hq, sh = [], []
    for h0 in range(0, hdim, block_h):
        sl = slice(h0, h0 + block_h)
        ig = int_matmul(xq, w1_q[sl]).float()
        h = gelu_tanh(ig * sx * w1_scale[sl].float() + b1[sl].float())
        s = (h.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
        hq.append(torch.round(h * (1.0 / s)).clamp(-127.0, 127.0)
                  .to(torch.int8))
        sh.append(s.reshape(-1))
    return torch.cat(hq, dim=1), torch.stack(sh)


def mlp_fc2_reference(hq: torch.Tensor, sh: torch.Tensor, w2_q: torch.Tensor,
                      block_h: int, groups: int = 1) -> torch.Tensor:
    """Plain version of the fc2 product: the hidden blocks dealt evenly to
    ``groups``, each group's fp32 accumulator ``acc = acc + float(hq_b .
    w2_b^T) * sh_b`` over its blocks in ascending order. Returns (groups,
    M, D) fp32."""
    blocks = sh.shape[0]
    if blocks % groups:
        raise ValueError(f"{blocks} hidden blocks do not split into "
                         f"{groups} groups")
    per = blocks // groups
    parts = []
    for g in range(groups):
        acc = torch.zeros((hq.shape[0], w2_q.shape[0]), dtype=torch.float32,
                          device=hq.device)
        for b in range(g * per, (g + 1) * per):
            sl = slice(b * block_h, (b + 1) * block_h)
            acc = acc + int_matmul(hq[:, sl], w2_q[:, sl]).float() \
                * sh[b].reshape(-1, 1)
        parts.append(acc)
    return torch.stack(parts)


def mlp_finish_reference(part: torch.Tensor, w2_scale: torch.Tensor,
                         b2: torch.Tensor, residual: torch.Tensor,
                         out_dtype: torch.dtype = torch.bfloat16,
                         ln_next=None):
    """Plain version of the finish pass: the groups' accumulators added in
    order, ``acc * sw2 + b2 + residual`` in fp32, cast once; ``ln_next =
    (gamma, beta, eps)`` also returns LayerNorm + int8 of that fp32
    output."""
    acc = part[0]
    for g in range(1, part.shape[0]):
        acc = acc + part[g]
    y = acc * w2_scale.float() + b2.float() + residual.float()
    out = y.to(out_dtype)
    if ln_next is None:
        return out
    gamma, beta, eps = ln_next
    nq, ns = ln_quant_rows(y, gamma, beta, eps)
    return out, nq, ns


def int8_mlp_reference(xq: torch.Tensor, sx: torch.Tensor,
                       w1_q: torch.Tensor, w1_scale: torch.Tensor,
                       b1: torch.Tensor, w2_q: torch.Tensor,
                       w2_scale: torch.Tensor, b2: torch.Tensor,
                       residual: torch.Tensor,
                       block_h: int = DEFAULT_BLOCK_H,
                       out_dtype: torch.dtype = torch.bfloat16,
                       ln_next=None):
    """Plain version of the kernel. xq (M, D) int8 with sx (M, 1); w1_q
    (H, D) and w2_q (D, H) int8, torch layout, with per-output-channel
    scales; residual (M, D) float. Per hidden block of ``block_h`` columns:
    ``h = gelu(float(xq . w1^T) * sx * sw1 + b1)``, one scale per row over
    the block, ``acc += float(hq . w2^T) * sh``. Output
    ``acc * sw2 + b2 + residual`` in fp32, cast once; ``ln_next = (gamma,
    beta, eps)`` also returns LayerNorm + int8 of that fp32 output. The
    three plain halves in a row, fc2 in one group."""
    hq, sh = mlp_fc1_reference(xq, sx, w1_q, w1_scale, b1, block_h)
    part = mlp_fc2_reference(hq, sh, w2_q, block_h)
    return mlp_finish_reference(part, w2_scale, b2, residual, out_dtype,
                                ln_next)


def int8_mlp(xq: torch.Tensor, sx: torch.Tensor, w1_q: torch.Tensor,
             w1_scale: torch.Tensor, b1: torch.Tensor, w2_q: torch.Tensor,
             w2_scale: torch.Tensor, b2: torch.Tensor, residual: torch.Tensor,
             block_h: int = DEFAULT_BLOCK_H,
             out_dtype: torch.dtype = torch.bfloat16, ln_next=None):
    """``residual + fc2(gelu(fc1(xq)))`` with int8 weights, one counted
    launch (three on the device): y (M, D) of ``out_dtype``, or ``(y, nq,
    ns)`` with ``ln_next = (gamma, beta, eps)``. Shapes as
    :func:`int8_mlp_reference`. On CUDA the shapes must satisfy
    :func:`mlp_tiles`, ``residual`` is of ``out_dtype`` and everything is
    contiguous; anything else raises."""
    if xq.dtype != torch.int8 or w1_q.dtype != torch.int8 \
            or w2_q.dtype != torch.int8:
        raise TypeError("int8_mlp takes int8 activations and weights")
    build.refuse_grad("int8_mlp", sx, b1, b2, residual,
                      *(ln_next[:2] if ln_next is not None else ()))
    if xq.device.type == "cpu":
        return int8_mlp_reference(xq, sx, w1_q, w1_scale, b1, w2_q, w2_scale,
                                  b2, residual, block_h, out_dtype, ln_next)
    if not xq.is_cuda:
        raise ValueError(f"int8_mlp takes CPU or CUDA tensors, not "
                         f"{xq.device}")
    m, d = xq.shape
    hdim = w1_q.shape[0]
    dev = xq.device
    fc1, fc2, groups = mlp_tiles(
        m, d, hdim, block_h,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if out_dtype not in _FLOATS:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    build.check_operand("x", xq, dev, (torch.int8,), (m, d))
    build.check_operand("x_scale", sx, dev, (torch.float32,))
    if sx.numel() != m:
        raise ValueError(f"x_scale has {sx.numel()} entries for {m} rows")
    build.check_operand("fc1 weight", w1_q, dev, (torch.int8,), (hdim, d))
    build.check_operand("fc1 scale", w1_scale, dev, (torch.float32,), (hdim,))
    build.check_operand("fc1 bias", b1, dev, _FLOATS, (hdim,))
    build.check_operand("fc2 weight", w2_q, dev, (torch.int8,), (d, hdim))
    build.check_operand("fc2 scale", w2_scale, dev, (torch.float32,), (d,))
    build.check_operand("fc2 bias", b2, dev, (b1.dtype,), (d,))
    build.check_operand("residual", residual, dev, (out_dtype,), (m, d))
    gamma = beta = nq = ns = None
    eps = 0.0
    if ln_next is not None:
        gamma, beta, eps = ln_next
        build.check_operand("ln weight", gamma, dev, _FLOATS, (d,))
        build.check_operand("ln bias", beta, dev, (gamma.dtype,), (d,))
        nq = torch.empty((m, d), dtype=torch.int8, device=dev)
        ns = torch.empty((m, 1), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=out_dtype, device=dev)
    if m == 0:
        return out if ln_next is None else (out, nq, ns)
    hq = torch.empty((m, hdim), dtype=torch.int8, device=dev)
    sh = torch.empty((hdim // block_h, m), dtype=torch.float32, device=dev)
    part = torch.empty((groups, m, d), dtype=torch.float32, device=dev)

    ptr = build.ptr
    rc = build.library().tae_int8_mlp_fwd(
        xq.data_ptr(), sx.data_ptr(), w1_q.data_ptr(), w1_scale.data_ptr(),
        b1.data_ptr(), w2_q.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(),
        residual.data_ptr(), out.data_ptr(), m, d, hdim, block_h,
        build.dtype_code(out_dtype), build.dtype_code(b1.dtype), ptr(gamma),
        ptr(beta), 0 if gamma is None else build.dtype_code(gamma.dtype),
        float(eps), ptr(nq), ptr(ns), hq.data_ptr(), sh.data_ptr(),
        part.data_ptr(), groups, fc1, fc2,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_int8_mlp_fwd")
    int8_mlp.launches += 1
    return out if ln_next is None else (out, nq, ns)


int8_mlp.launches = 0
