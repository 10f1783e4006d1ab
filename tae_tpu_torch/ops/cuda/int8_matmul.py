"""K4: int8 matmul with a fused dequantize epilogue (counterpart of
``tae_tpu/ops/pallas/int8_matmul.py::int8_matmul_fused``; source
``tae_tpu_torch/csrc/int8_matmul.cu``) and its plain version.

Ported: prequantized input (int8 x with one scale per row), bias, residual
and the chained ``ln_out`` epilogue. The ``q8_out`` output mode and the
in-kernel quantization of a float x wait for the int8-input attention
kernel that consumes them (ROADMAP B15).

Weights are stored torch-style, ``(N, K)``, so both operands of the product
are contiguous along K.
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import build

_FLOATS = (torch.float32, torch.bfloat16)
#: dynamic shared memory one block may use on sm_90 (bytes)
SMEM_LIMIT = 232448
#: (rows per block, columns per tile) of the row-block kernels (the ln_out
#: form of K4, and K5), in the order they are tried
ROW_BLOCKS = ((32, 256), (16, 128))


def ring_bytes(rows: int, cols: int) -> int:
    """Shared memory of csrc/int8_common.cuh's operand ring: three stages
    of a (rows + cols) x 64-byte tile pair, rows padded to 80 bytes."""
    return 3 * (rows + cols) * 80


def tile_bytes(rows: int, cols: int) -> int:
    """An int32 result tile, rows padded by 4 columns."""
    return rows * (cols + 4) * 4


def ln_chain_rows(n: int) -> int | None:
    """Rows per block of the chained ``ln_out`` epilogue for an N-wide
    output, or None when the chain is off.

    The epilogue needs LayerNorm statistics over a full fp32 output row, so
    a block keeps its ``rows x (N + 4)`` fp32 outputs in shared memory
    beside the operand ring. The rule: 32 rows per block (256-column tiles)
    if that fits the 232,448 bytes a block may use, else 16 rows
    (128-column tiles), else no chain (the caller then runs the standalone
    ``ln_quant``). That is 32 rows up to N = 1272, 16 up to N = 3088, and
    none beyond; N must be a multiple of 8 either way.
    """
    if n % 8:
        return None
    for rows, cols in ROW_BLOCKS:
        work = max(ring_bytes(rows, cols), tile_bytes(rows, cols))
        if rows * (n + 4) * 4 + work <= SMEM_LIMIT:
            return rows
    return None


def int_matmul(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x (N, K)^T product, returned as float64 (every
    partial sum is an integer below 2^53, so float64 carries it exactly on
    the CPU and on the card alike)."""
    return torch.matmul(a.double(), b_nk.double().t())


def ln_quant_rows(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The LN + quantize body shared by ``ln_quant`` and the chained
    epilogues, on fp32 rows y (M, D): two-pass fp32 statistics, rsqrt,
    s = max(max|z| / 127, 1e-12), codes round_half_even(z * (1 / s))."""
    mean = y.mean(dim=-1, keepdim=True)
    yc = y - mean
    var = (yc * yc).mean(dim=-1, keepdim=True)
    z = yc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    s = (z.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(z * (1.0 / s)).clamp(-127.0, 127.0).to(torch.int8)
    return q, s


def int8_matmul_reference(xq: torch.Tensor, sx: torch.Tensor,
                          w_q: torch.Tensor, w_scale: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          residual: torch.Tensor | None = None,
                          out_dtype: torch.dtype = torch.bfloat16,
                          ln_out=None):
    """Plain version of the kernel. xq (M, K) int8, sx (M, 1) f32, w_q
    (N, K) int8, w_scale (N,) f32 -> y (M, N) of ``out_dtype``:
    ``float(acc) * sx * sw (+ bias) (+ residual)`` in fp32, cast once.
    ``ln_out = (gamma, beta, eps)`` also returns the int8 codes and (M, 1)
    scales of LayerNorm(y) taken from the fp32 y."""
    acc = int_matmul(xq, w_q).float()
    y = acc * sx.reshape(-1, 1) * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    out = y.to(out_dtype)
    if ln_out is None:
        return out
    gamma, beta, eps = ln_out
    nq, ns = ln_quant_rows(y, gamma, beta, eps)
    return out, nq, ns


def int8_matmul_fused(xq: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None,
                      out_dtype: torch.dtype = torch.bfloat16, ln_out=None):
    """xq (M, K) int8 with scales sx (M, 1) against w_q (N, K) int8 with
    scales w_scale (N,) -> y (M, N), or ``(y, nq, ns)`` with
    ``ln_out = (gamma, beta, eps)``.

    On CUDA: K a multiple of 16, N a multiple of 8, ``out_dtype`` float32 or
    bfloat16, ``residual`` of ``out_dtype``, everything contiguous;
    ``ln_out`` only where :func:`ln_chain_rows` gives a block size. Anything
    else raises."""
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul_fused takes int8 operands, got "
                        f"{xq.dtype} and {w_q.dtype}")
    if xq.ndim != 2 or w_q.ndim != 2 or xq.shape[1] != w_q.shape[1]:
        raise ValueError(f"x {tuple(xq.shape)} and w {tuple(w_q.shape)} are "
                         "not (M, K) and (N, K)")
    (m, k), n = xq.shape, w_q.shape[0]
    build.refuse_grad("int8_matmul_fused", sx, bias, residual,
                      *(ln_out[:2] if ln_out is not None else ()))
    if xq.device.type == "cpu":
        return int8_matmul_reference(xq, sx, w_q, w_scale, bias, residual,
                                     out_dtype, ln_out)
    if not xq.is_cuda:
        raise ValueError(f"int8_matmul_fused takes CPU or CUDA tensors, not "
                         f"{xq.device}")
    if k % 16 or n % 8 or k < 16:
        raise ValueError(f"int8_matmul_fused needs K a multiple of 16 and N a "
                         f"multiple of 8, got ({m}, {k}) x ({n}, {k})")
    if out_dtype not in _FLOATS:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    dev = xq.device
    build.check_operand("x", xq, dev, (torch.int8,))
    build.check_operand("x_scale", sx, dev, (torch.float32,))
    if sx.numel() != m:
        raise ValueError(f"x_scale has {sx.numel()} entries for {m} rows")
    build.check_operand("w", w_q, dev, (torch.int8,))
    build.check_operand("w_scale", w_scale, dev, (torch.float32,), (n,))
    if bias is not None:
        build.check_operand("bias", bias, dev, _FLOATS, (n,))
    if residual is not None:
        build.check_operand("residual", residual, dev, (out_dtype,), (m, n))
    ln_rows, nq, ns = 0, None, None
    gamma = beta = None
    eps = 0.0
    if ln_out is not None:
        gamma, beta, eps = ln_out
        ln_rows = ln_chain_rows(n)
        if ln_rows is None:
            raise ValueError(f"the ln_out epilogue does not take N={n} "
                             "(see ln_chain_rows)")
        build.check_operand("ln weight", gamma, dev, _FLOATS, (n,))
        build.check_operand("ln bias", beta, dev, (gamma.dtype,), (n,))
        nq = torch.empty((m, n), dtype=torch.int8, device=dev)
        ns = torch.empty((m, 1), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out if ln_out is None else (out, nq, ns)

    ptr = build.ptr
    rc = build.library().tae_int8_matmul_fwd(
        xq.data_ptr(), sx.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
        ptr(bias), ptr(residual), out.data_ptr(), m, n, k,
        build.dtype_code(out_dtype),
        0 if bias is None else build.dtype_code(bias.dtype), ln_rows,
        ptr(gamma), ptr(beta),
        0 if gamma is None else build.dtype_code(gamma.dtype), float(eps),
        ptr(nq), ptr(ns), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_int8_matmul_fwd")
    int8_matmul_fused.launches += 1
    return out if ln_out is None else (out, nq, ns)


int8_matmul_fused.launches = 0
