"""K4: int8 matmul with a fused dequantize epilogue (counterpart of
``tae_tpu/ops/pallas/int8_matmul.py::int8_matmul_fused``; source
``tae_tpu_torch/csrc/int8_matmul.cu``) and its plain version.

:func:`int8_matmul_fused`: prequantized input (int8 x with one scale per
row), bias, residual and the chained ``ln_out`` epilogue.
:func:`int8_matmul_rows`: the ``q8_out`` output mode (int8 y with one scale
per row and block of ``q8_block`` columns, the input of the int8-input
attention K15) and the in-kernel quantization of a float x from its
precomputed row scales (``prequantize=False`` in the JAX package), which
share the kernel's row-block form. The two entries count their launches
apart.

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


def _epilogue_f32(xq, sx, w_q, w_scale, bias, residual) -> torch.Tensor:
    """``float(acc) * sx * sw (+ bias) (+ residual)`` in fp32."""
    acc = int_matmul(xq, w_q).float()
    y = acc * sx.reshape(-1, 1) * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y


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
    y = _epilogue_f32(xq, sx, w_q, w_scale, bias, residual)
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


def quantize_with_scales(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """The in-kernel quantize of a float x (M, K) with its row scales sx
    (M, 1): clip(round_half_even(x * (1 / sx)), +-127) in fp32, as the
    Pallas body's ``quantize_in_kernel`` (an exact reciprocal, then a
    product: not the division of the prequantize pass)."""
    inv = 1.0 / sx.reshape(-1, 1).float()
    return torch.round(x.float() * inv).clamp(-127.0, 127.0).to(torch.int8)


def quantize_blocks(y: torch.Tensor, block: int):
    """The ``q8_out`` epilogue on fp32 y (M, N): per row and block of
    ``block`` columns s = max(max|y| / 127, 1e-12), codes
    clip(round_half_even(y * (1 / s)), +-127). Returns (int8 (M, N), fp32
    scales (N / block, M, 1))."""
    m, n = y.shape
    yb = y.reshape(m, n // block, block)
    s = (yb.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(yb * (1.0 / s)).clamp(-127.0, 127.0).to(torch.int8)
    return q.reshape(m, n), s.permute(1, 0, 2).contiguous()


def int8_matmul_rows_reference(x: torch.Tensor, sx: torch.Tensor,
                               w_q: torch.Tensor, w_scale: torch.Tensor,
                               bias: torch.Tensor | None = None,
                               residual: torch.Tensor | None = None,
                               out_dtype: torch.dtype = torch.bfloat16,
                               q8_block: int | None = None):
    """Plain version of :func:`int8_matmul_rows`: a float x is quantized by
    :func:`quantize_with_scales` first; the fp32 epilogue of
    :func:`int8_matmul_reference`; then ``q8_block``: :func:`quantize_blocks`
    (``(yq, ys)``), or None: y cast to ``out_dtype``."""
    xq = x if x.dtype == torch.int8 else quantize_with_scales(x, sx)
    y = _epilogue_f32(xq, sx, w_q, w_scale, bias, residual)
    if q8_block is None:
        return y.to(out_dtype)
    return quantize_blocks(y, q8_block)


def int8_matmul_rows(x: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.bfloat16,
                     q8_block: int | None = None):
    """K4's row-block form. x (M, K): int8 codes, or a float x that the
    kernel quantizes with its row scales sx (M, 1) (the JAX package's
    ``prequantize=False``). ``q8_block``: the ``q8_out`` mode, returning
    ``(yq (M, N) int8, ys (N / q8_block, M, 1) fp32)``, one scale per row
    and block of ``q8_block`` columns; None: y (M, N) of ``out_dtype``,
    which needs a float x (int8 codes take :func:`int8_matmul_fused`).
    ``residual`` is added in fp32 before either. On CUDA: K a multiple of
    16, N of 8, ``q8_block`` of 8 dividing N, a float x of float32 or
    bfloat16 with K small enough for the block's (32 x K) int8 tile (K <=
    3968 with ``q8_block`` 512), everything contiguous; anything else
    raises."""
    if w_q.dtype != torch.int8 or x.ndim != 2 or w_q.ndim != 2 \
            or x.shape[1] != w_q.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} and w "
                         f"{tuple(w_q.shape)} {w_q.dtype} are not (M, K) and "
                         "int8 (N, K)")
    (m, k), n = x.shape, w_q.shape[0]
    if q8_block is not None and (q8_block < 8 or q8_block % 8 or n % q8_block):
        raise ValueError(f"q8_block {q8_block} must be a multiple of 8 that "
                         f"divides N={n}")
    if q8_block is None and x.dtype == torch.int8:
        raise ValueError("int8 codes without q8_out take int8_matmul_fused")
    build.refuse_grad("int8_matmul_rows", x, sx, bias, residual)
    if x.device.type == "cpu":
        return int8_matmul_rows_reference(x, sx, w_q, w_scale, bias, residual,
                                          out_dtype, q8_block)
    if not x.is_cuda:
        raise ValueError(f"int8_matmul_rows takes CPU or CUDA tensors, not "
                         f"{x.device}")
    if k % 16 or n % 8 or k < 16:
        raise ValueError(f"int8_matmul_rows needs K a multiple of 16 and N a "
                         f"multiple of 8, got ({m}, {k}) x ({n}, {k})")
    dev = x.device
    build.check_operand("x", x, dev, (torch.int8, *_FLOATS))
    build.check_operand("x_scale", sx, dev, (torch.float32,))
    if sx.numel() != m:
        raise ValueError(f"x_scale has {sx.numel()} entries for {m} rows")
    build.check_operand("w", w_q, dev, (torch.int8,))
    build.check_operand("w_scale", w_scale, dev, (torch.float32,), (n,))
    if bias is not None:
        build.check_operand("bias", bias, dev, _FLOATS, (n,))
    res_dtype = out_dtype if residual is None else residual.dtype
    if residual is not None:
        build.check_operand("residual", residual, dev, _FLOATS, (m, n))
    if q8_block is None:
        if residual is not None and residual.dtype != out_dtype:
            raise TypeError("residual must have out_dtype")
        out, so = torch.empty((m, n), dtype=out_dtype, device=dev), None
    else:
        out = torch.empty((m, n), dtype=torch.int8, device=dev)
        so = torch.empty((n // q8_block, m, 1), dtype=torch.float32, device=dev)
    if m == 0:
        return out if so is None else (out, so)
    x_code = 2 if x.dtype == torch.int8 else build.dtype_code(x.dtype)
    rc = build.library().tae_int8_matmul_rows_fwd(
        x.data_ptr(), x_code, sx.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
        build.ptr(bias), 0 if bias is None else build.dtype_code(bias.dtype),
        build.ptr(residual), out.data_ptr(), build.dtype_code(res_dtype),
        build.ptr(so), q8_block or 0, m, n, k,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_int8_matmul_rows_fwd")
    int8_matmul_rows.launches += 1
    return out if so is None else (out, so)


int8_matmul_rows.launches = 0
