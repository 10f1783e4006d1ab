"""K12: w4a8 matmul with group-wise dequantization (counterpart of
``tae_tpu/ops/pallas/int4_matmul.py::int4_matmul_fused``; source
``tae_tpu_torch/csrc/int4_matmul.cu``), its plain version, and the packed
int4 byte layout both share.

The byte layout (:data:`LAYOUT`, ``"k32-twos"``). A weight of ``N`` output
channels and ``K`` inputs is stored torch-style and K-contiguous, ``(N,
K/2)`` bytes per :func:`pack_int4`: within every run of 32 consecutive K
values, byte ``j`` (0 <= j < 16) holds element ``j`` in its low nibble and
element ``16 + j`` in its high nibble, both as two's-complement nibbles of
the code in [-7, 7]. The tensor-core instruction the kernel issues
(``mma.sync.m16n8k32``, int8) wants, per thread, the four K-consecutive
bytes ``4t .. 4t+3`` and ``16+4t .. 16+4t+3`` of one output channel: one
32-bit word of this layout holds exactly those eight codes, and ``(w << 4)
& 0xF0F0F0F0`` / ``w & 0xF0F0F0F0`` turn it into the two operand registers,
each byte 16 times its code (the int32 group sum is shifted back by 4,
exactly). Three integer operations decode eight weights, in registers, with
no second tile in shared memory. (The JAX package's nibble planes and
offset-8 bytes answer its own target's rules; codes and scales are equal in
both packages, only the bytes are arranged differently, and
:mod:`tae_tpu_torch.ckpt.bridge` repacks.)

Scales are ``(K/G, N)`` fp32, one per (group of ``G`` consecutive inputs,
output channel), as in the JAX package.

Order of the fp32 sums, the same in the kernel and the plain version: the
groups are added in ascending K order, ``acc = acc + float(ig_g) * s_g``,
every product and sum rounded separately; then ``acc * sx (+ bias)
(+ residual)``, cast once. (The JAX kernel adds group ``g`` of the low plane
and group ``g`` of the high plane per step: another order of the same
exact terms, so the two agree to fp32 rounding, not bit for bit.)
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.int8_matmul import int_matmul

_FLOATS = (torch.float32, torch.bfloat16)
#: name of the packed byte layout, recorded in the serving artifact
LAYOUT = "k32-twos"
#: K values per run of the layout: pack / unpack need K a multiple of it
RUN = 32
#: output tile (rows, columns) of the kernel's two forms: the large tile
#: where it alone fills the card, the small one for few rows
TILES = ((128, 128), (32, 64))


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Codes ``q`` (..., N, K) in [-7, 7] (any integer dtype) -> (..., N,
    K/2) uint8 in the :data:`LAYOUT` layout."""
    *lead, n, k = q.shape
    if k % RUN:
        raise ValueError(f"int4 packing needs K a multiple of {RUN}, got {k}")
    r = q.reshape(*lead, n, k // RUN, 2, RUN // 2).to(torch.int16)
    byte = (r[..., 0, :] & 15) | ((r[..., 1, :] & 15) << 4)
    return byte.reshape(*lead, n, k // 2).to(torch.uint8)


def unpack_int4(w4: torch.Tensor) -> torch.Tensor:
    """(..., N, K/2) uint8 in the :data:`LAYOUT` layout -> int8 codes
    (..., N, K) in [-7, 7] (inverse of :func:`pack_int4`)."""
    *lead, n, half = w4.shape
    if w4.dtype != torch.uint8 or half % (RUN // 2):
        raise ValueError(f"packed int4 is uint8 (N, K/2) with K a multiple of "
                         f"{RUN}, got {w4.dtype} {tuple(w4.shape)}")
    b = w4.reshape(*lead, n, half // (RUN // 2), RUN // 2).to(torch.int16)
    lo = ((b & 15) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack((lo, hi), dim=-2).reshape(*lead, n, 2 * half).to(
        torch.int8)


def group_of(w4: torch.Tensor, w_scale: torch.Tensor) -> int:
    """Inputs per scale group of a packed weight and its (K/G, N) scales."""
    k, n_groups = 2 * w4.shape[-1], w_scale.shape[-2]
    if n_groups < 1 or k % n_groups or w_scale.shape[-1] != w4.shape[-2]:
        raise ValueError(f"scales {tuple(w_scale.shape)} do not group a "
                         f"packed weight {tuple(w4.shape)}")
    return k // n_groups


def group_products(xq: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor,
                   group: int) -> torch.Tensor:
    """``sum_g float(xq_g . q_g^T) * w_scale[g]`` over the K groups in
    ascending order, each term and each partial sum rounded to fp32: xq
    (M, K) int8, codes q (N, K), scales (K/G, N) -> (M, N) fp32."""
    acc = torch.zeros((xq.shape[0], q.shape[0]), dtype=torch.float32,
                      device=xq.device)
    for g in range(w_scale.shape[0]):
        sl = slice(g * group, (g + 1) * group)
        acc = acc + int_matmul(xq[:, sl], q[:, sl]).float() * w_scale[g]
    return acc


def int4_matmul_reference(xq: torch.Tensor, sx: torch.Tensor,
                          w4: torch.Tensor, w_scale: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          residual: torch.Tensor | None = None,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Plain version of the kernel. xq (M, K) int8, sx (M, 1) f32, w4
    (N, K/2) packed, w_scale (K/G, N) f32 -> y (M, N) of ``out_dtype``; the
    order of the sums is the module's."""
    acc = group_products(xq, unpack_int4(w4), w_scale.float(),
                         group_of(w4, w_scale))
    y = acc * sx.reshape(-1, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def check_weight(name: str, w4: torch.Tensor, w_scale: torch.Tensor, dev,
                 k: int) -> int:
    """Raise unless (w4, w_scale) is a packed weight of K inputs the kernels
    can read on ``dev``; returns its group size."""
    n = w4.shape[0]
    build.check_operand(f"{name} weight", w4, dev, (torch.uint8,), (n, k // 2))
    group = group_of(w4, w_scale)
    if group % 64 or k % group:
        raise ValueError(f"{name}: the kernel takes scale groups that are a "
                         f"multiple of 64 inputs, got {group}")
    build.check_operand(f"{name} scale", w_scale, dev, (torch.float32,),
                        (k // group, n))
    return group


def int4_matmul_fused(xq: torch.Tensor, sx: torch.Tensor, w4: torch.Tensor,
                      w_scale: torch.Tensor, bias: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """xq (M, K) int8 with scales sx (M, 1) against the packed weight w4
    (N, K/2) with group scales w_scale (K/G, N) -> y (M, N).

    On CUDA: G a multiple of 64 that divides K, N a multiple of 8,
    ``out_dtype`` float32 or bfloat16, ``residual`` of ``out_dtype``,
    everything contiguous. Anything else raises."""
    if xq.dtype != torch.int8 or w4.dtype != torch.uint8:
        raise TypeError(f"int4_matmul_fused takes int8 rows and uint8 packed "
                        f"weights, got {xq.dtype} and {w4.dtype}")
    if xq.ndim != 2 or w4.ndim != 2 or xq.shape[1] != 2 * w4.shape[1]:
        raise ValueError(f"x {tuple(xq.shape)} and w4 {tuple(w4.shape)} are "
                         "not (M, K) and (N, K/2)")
    (m, k), n = xq.shape, w4.shape[0]
    build.refuse_grad("int4_matmul_fused", sx, bias, residual)
    if xq.device.type == "cpu":
        return int4_matmul_reference(xq, sx, w4, w_scale, bias, residual,
                                     out_dtype)
    if not xq.is_cuda:
        raise ValueError(f"int4_matmul_fused takes CPU or CUDA tensors, not "
                         f"{xq.device}")
    if n % 8:
        raise ValueError(f"int4_matmul_fused needs N a multiple of 8, got {n}")
    if out_dtype not in _FLOATS:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    dev = xq.device
    build.check_operand("x", xq, dev, (torch.int8,))
    build.check_operand("x_scale", sx, dev, (torch.float32,))
    if sx.numel() != m:
        raise ValueError(f"x_scale has {sx.numel()} entries for {m} rows")
    group = check_weight("int4_matmul_fused", w4, w_scale, dev, k)
    if bias is not None:
        build.check_operand("bias", bias, dev, _FLOATS, (n,))
    if residual is not None:
        build.check_operand("residual", residual, dev, (out_dtype,), (m, n))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    # the large tile where its blocks alone fill the card, else the small
    # one: few rows leave most SMs idle unless N is cut finely
    (bm, bn), sms = TILES[0], torch.cuda.get_device_properties(
        dev).multi_processor_count
    small = -(-m // bm) * -(-n // bn) < sms
    rc = build.library().tae_int4_matmul_fwd(
        xq.data_ptr(), sx.data_ptr(), w4.data_ptr(), w_scale.data_ptr(),
        build.ptr(bias), build.ptr(residual), out.data_ptr(), m, n, k, group,
        build.dtype_code(out_dtype),
        0 if bias is None else build.dtype_code(bias.dtype), int(small),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_int4_matmul_fwd")
    int4_matmul_fused.launches += 1
    return out


int4_matmul_fused.launches = 0
