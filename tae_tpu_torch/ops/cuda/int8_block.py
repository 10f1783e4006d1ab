"""K3 ``ln_quant`` and K5 ``int8_mlp``: the fused kernels of the int8 serving
block (counterparts of ``tae_tpu/ops/pallas/int8_block.py::ln_quant`` and
``::int8_mlp``; source ``tae_tpu_torch/csrc/int8_block.cu``) and their plain
versions.

``block_h`` is part of ``int8_mlp``'s numerics, not a tuning knob: the hidden
activation gets one int8 scale per (row, block of ``block_h`` hidden
columns), so another ``block_h`` gives other outputs. The kernel and the
plain version take the same explicit value; :data:`DEFAULT_BLOCK_H` is the
one the serving path uses.
"""

from __future__ import annotations

import math

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.int8_matmul import (ROW_BLOCKS, SMEM_LIMIT,
                                                int_matmul, ln_quant_rows,
                                                ring_bytes)

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


def mlp_block_rows(d: int, hdim: int, block_h: int) -> int:
    """Rows per block of the kernel: a block holds its rows' full D-wide
    fp32 accumulator, the hidden block's int8 codes, the operand ring and a
    (rows x block_h) fp32 hidden buffer in shared memory (the buffer lies
    over the ring when block_h is no wider than a tile). 32 rows with
    256-column tiles if that fits the 232,448 bytes a block may use, else
    16 rows with 128-column tiles; raises if neither does or if the shapes
    do not tile."""
    if block_h < 128 or block_h % 128 or hdim % block_h:
        raise ValueError(f"int8_mlp needs block_h a multiple of 128 that "
                         f"divides the hidden dim, got block_h={block_h}, "
                         f"hidden={hdim}")
    if d % 16 or d < 16:
        raise ValueError(f"int8_mlp needs D a multiple of 16, got {d}")
    for rows, cols in ROW_BLOCKS:
        fixed = rows * ((d + 4) * 4 + block_h + 16 + 4)
        hidden = rows * (-(-block_h // cols) * cols + 4) * 4
        ring = ring_bytes(rows, cols)
        work = max(ring, hidden) if block_h <= cols else ring + hidden
        if fixed + work <= SMEM_LIMIT:
            return rows
    raise ValueError(f"int8_mlp does not take D={d} with block_h={block_h}: "
                     "16 rows of it exceed a block's shared memory")


def mlp_hidden_groups(row_blocks: int, hidden_blocks: int, sms: int) -> int:
    """Groups the kernel splits the hidden blocks into. A launch has one
    block per ``mlp_block_rows`` rows, one block fits an SM, and few rows
    leave most SMs idle (M = 256 is 8 blocks), so the hidden blocks are
    dealt evenly to as many groups as keep ``row_blocks * groups`` within
    the card's ``sms``: each group sums its fc2 partials in fp32 and a
    second kernel adds the groups in order and runs the epilogue. 1 (no
    split, one kernel) from half the SMs' worth of row blocks on. The fp32
    summation order, and so the last bit of a sum, follows the group
    count."""
    return max(g for g in range(1, hidden_blocks + 1)
               if hidden_blocks % g == 0 and (g == 1 or row_blocks * g <= sms))


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
    beta, eps)`` also returns LayerNorm + int8 of that fp32 output."""
    hdim = w1_q.shape[0]
    if block_h < 1 or hdim % block_h:
        raise ValueError(f"hidden dim {hdim} is not a multiple of block_h "
                         f"{block_h}")
    sx = sx.reshape(-1, 1)
    acc = torch.zeros((xq.shape[0], w2_q.shape[0]), dtype=torch.float32,
                      device=xq.device)
    for h0 in range(0, hdim, block_h):
        sl = slice(h0, h0 + block_h)
        ig = int_matmul(xq, w1_q[sl]).float()
        h = gelu_tanh(ig * sx * w1_scale[sl].float() + b1[sl].float())
        sh = (h.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
        hq = torch.round(h * (1.0 / sh)).clamp(-127.0, 127.0).to(torch.int8)
        acc = acc + int_matmul(hq, w2_q[:, sl]).float() * sh
    y = acc * w2_scale.float() + b2.float() + residual.float()
    out = y.to(out_dtype)
    if ln_next is None:
        return out
    gamma, beta, eps = ln_next
    nq, ns = ln_quant_rows(y, gamma, beta, eps)
    return out, nq, ns


def int8_mlp(xq: torch.Tensor, sx: torch.Tensor, w1_q: torch.Tensor,
             w1_scale: torch.Tensor, b1: torch.Tensor, w2_q: torch.Tensor,
             w2_scale: torch.Tensor, b2: torch.Tensor, residual: torch.Tensor,
             block_h: int = DEFAULT_BLOCK_H,
             out_dtype: torch.dtype = torch.bfloat16, ln_next=None):
    """``residual + fc2(gelu(fc1(xq)))`` with int8 weights, one kernel:
    y (M, D) of ``out_dtype``, or ``(y, nq, ns)`` with ``ln_next = (gamma,
    beta, eps)``. Shapes as :func:`int8_mlp_reference`. On CUDA the shapes
    must satisfy :func:`mlp_block_rows`, ``residual`` is of ``out_dtype``
    and everything is contiguous; anything else raises."""
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
    rows = mlp_block_rows(d, hdim, block_h)
    if out_dtype not in _FLOATS:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    dev = xq.device
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
    groups = mlp_hidden_groups(
        -(-m // rows), hdim // block_h,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part = (torch.empty((groups, m, d), dtype=torch.float32, device=dev)
            if groups > 1 else None)

    ptr = build.ptr
    rc = build.library().tae_int8_mlp_fwd(
        xq.data_ptr(), sx.data_ptr(), w1_q.data_ptr(), w1_scale.data_ptr(),
        b1.data_ptr(), w2_q.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(),
        residual.data_ptr(), out.data_ptr(), m, d, hdim, block_h, rows,
        build.dtype_code(out_dtype), build.dtype_code(b1.dtype), ptr(gamma),
        ptr(beta), 0 if gamma is None else build.dtype_code(gamma.dtype),
        float(eps), ptr(nq), ptr(ns), ptr(part), groups,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_int8_mlp_fwd")
    int8_mlp.launches += 1
    return out if ln_next is None else (out, nq, ns)


int8_mlp.launches = 0
