"""K13 ``int4_mlp``: the fused w4a8 MLP of the int4 serving block
(counterpart of ``tae_tpu/ops/pallas/int4_block.py::int4_mlp``; source
``tae_tpu_torch/csrc/int4_block.cu``) and its plain version.

``residual + fc2(gelu_tanh(fc1(xq)))`` with both weights in the packed int4
layout of :mod:`tae_tpu_torch.ops.cuda.int4_matmul`; the (M, 4D) hidden
activation is requantized per (row, block of ``block_h`` hidden columns) and
never reaches device memory.

``block_h`` is part of the numerics, as in ``int8_mlp``: one int8 scale per
(row, hidden block). The port uses one value for both fused MLPs,
:data:`~tae_tpu_torch.ops.cuda.int8_block.DEFAULT_BLOCK_H` (256): the
kernel's block holds a whole hidden block's fp32 values in its registers
between fc1 and the requantize, and at 256 columns one hidden block is one
fc2 scale group. The JAX package defaults to 512; the tests pin it to the
port's value.

Order of the fp32 sums, the same in the kernel and the plain version. Per
hidden block, in ascending order: fc1's groups in ascending K order (``h =
h + float(ig_g) * s1_g``), ``h * sx + b1``, GELU, the scale ``max(amax /
127, 1e-12)`` and the codes ``round(h * (1 / sh))``, fc2's groups within the
block ascending (``part = part + float(ig_g) * s2_g``), ``acc = acc + part
* sh``. With ``groups > 1`` the hidden blocks are dealt to that many
consecutive runs, each summed as above from zero, and the runs are added in
order; then ``+ b2 + residual``, cast once. (The JAX kernel walks the hidden
blocks in plane pairs, which its byte layout asks for; the terms are the
same.)
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.int4_matmul import (check_weight, group_of,
                                                group_products, unpack_int4)
from tae_tpu_torch.ops.cuda.int8_block import (DEFAULT_BLOCK_H, gelu_tanh,
                                               mlp_hidden_groups)
from tae_tpu_torch.ops.cuda.int8_matmul import SMEM_LIMIT

_FLOATS = (torch.float32, torch.bfloat16)
#: rows of one kernel block, and the hidden block it is written for
BLOCK_ROWS = 16
KERNEL_BLOCK_H = DEFAULT_BLOCK_H


def mlp_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one kernel block at width ``d`` (mirrors
    ``mlp4_smem`` of csrc/int4_block.cu): the fp32 accumulator of 16 full
    output rows, the hidden block's int8 codes, the per-warp row maxima and
    a four-stage ring of (16 x 64 int8, 256 x 32 packed) operand tiles."""
    acc = BLOCK_ROWS * (d + 8) * 4
    codes = BLOCK_ROWS * (KERNEL_BLOCK_H + 16)
    amax = 8 * BLOCK_ROWS * 4
    ring = 4 * (BLOCK_ROWS * 80 + KERNEL_BLOCK_H * 48)
    return acc + codes + amax + ring


def int4_mlp_reference(xq: torch.Tensor, sx: torch.Tensor, w1_4: torch.Tensor,
                       w1_scale: torch.Tensor, b1: torch.Tensor,
                       w2_4: torch.Tensor, w2_scale: torch.Tensor,
                       b2: torch.Tensor, residual: torch.Tensor,
                       block_h: int = DEFAULT_BLOCK_H,
                       out_dtype: torch.dtype = torch.bfloat16,
                       groups: int = 1) -> torch.Tensor:
    """Plain version of the kernel. xq (M, D) int8 with sx (M, 1); w1_4
    (H, D/2) and w2_4 (D, H/2) packed, with (D/G1, H) and (H/G2, D) group
    scales; residual (M, D) float. The order of the sums is the module's;
    ``groups`` is the number of runs the hidden blocks are dealt to (the
    kernel's grid split for few rows)."""
    hdim, d = w1_4.shape[0], w2_4.shape[0]
    g1, g2 = group_of(w1_4, w1_scale), group_of(w2_4, w2_scale)
    n_h = hdim // block_h if block_h > 0 else 0
    if block_h < 1 or hdim % block_h or block_h % g2:
        raise ValueError(f"hidden dim {hdim} is not a multiple of block_h "
                         f"{block_h}, or fc2's group {g2} does not divide it")
    if groups < 1 or n_h % groups:
        raise ValueError(f"{n_h} hidden blocks do not split into {groups} "
                         "groups")
    q1, q2 = unpack_int4(w1_4), unpack_int4(w2_4)
    s1, s2 = w1_scale.float(), w2_scale.float()
    sx = sx.reshape(-1, 1)
    total = None
    for run in range(groups):
        acc = torch.zeros((xq.shape[0], d), dtype=torch.float32,
                          device=xq.device)
        for hb in range(run * (n_h // groups), (run + 1) * (n_h // groups)):
            sl = slice(hb * block_h, (hb + 1) * block_h)
            h = group_products(xq, q1[sl], s1[:, sl], g1)
            h = gelu_tanh(h * sx + b1[sl].float())
            sh = (h.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
            hq = torch.round(h * (1.0 / sh)).clamp(-127.0, 127.0).to(torch.int8)
            gs = slice(hb * block_h // g2, (hb + 1) * block_h // g2)
            acc = acc + group_products(hq, q2[:, sl], s2[gs], g2) * sh
        total = acc if total is None else total + acc
    return (total + b2.float() + residual.float()).to(out_dtype)


def int4_mlp(xq: torch.Tensor, sx: torch.Tensor, w1_4: torch.Tensor,
             w1_scale: torch.Tensor, b1: torch.Tensor, w2_4: torch.Tensor,
             w2_scale: torch.Tensor, b2: torch.Tensor, residual: torch.Tensor,
             block_h: int = DEFAULT_BLOCK_H,
             out_dtype: torch.dtype = torch.bfloat16,
             groups: int | None = None) -> torch.Tensor:
    """``residual + fc2(gelu(fc1(xq)))`` with packed int4 weights, one
    kernel (two when the hidden blocks are split over the grid): y (M, D) of
    ``out_dtype``. Shapes as :func:`int4_mlp_reference`. ``groups=None``
    lets the kernel deal the hidden blocks to as many runs as fill the card
    (:func:`~tae_tpu_torch.ops.cuda.int8_block.mlp_hidden_groups`; the plain
    version on a CPU tensor takes 1). On CUDA ``block_h`` must be 256, both
    scale groups multiples of 64 with fc2's dividing 256, D a multiple of 8
    whose 16 fp32 rows fit a block's shared memory, ``residual`` of
    ``out_dtype`` and everything contiguous; anything else raises."""
    if xq.dtype != torch.int8 or w1_4.dtype != torch.uint8 \
            or w2_4.dtype != torch.uint8:
        raise TypeError("int4_mlp takes int8 activations and uint8 packed "
                        "weights")
    build.refuse_grad("int4_mlp", sx, b1, b2, residual)
    if xq.device.type == "cpu":
        return int4_mlp_reference(xq, sx, w1_4, w1_scale, b1, w2_4, w2_scale,
                                  b2, residual, block_h, out_dtype,
                                  groups or 1)
    if not xq.is_cuda:
        raise ValueError(f"int4_mlp takes CPU or CUDA tensors, not "
                         f"{xq.device}")
    m, d = xq.shape
    hdim = w1_4.shape[0]
    if block_h != KERNEL_BLOCK_H or hdim % block_h:
        raise ValueError(f"the int4_mlp kernel is written for block_h "
                         f"{KERNEL_BLOCK_H} dividing the hidden dim, got "
                         f"block_h={block_h}, hidden={hdim}")
    if d % 8 or mlp_smem_bytes(d) > SMEM_LIMIT:
        raise ValueError(f"int4_mlp does not take D={d}: it needs a multiple "
                         f"of 8 whose {BLOCK_ROWS} fp32 rows fit a block's "
                         "shared memory")
    if out_dtype not in _FLOATS:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    dev = xq.device
    build.check_operand("x", xq, dev, (torch.int8,), (m, d))
    build.check_operand("x_scale", sx, dev, (torch.float32,))
    if sx.numel() != m:
        raise ValueError(f"x_scale has {sx.numel()} entries for {m} rows")
    g1 = check_weight("fc1", w1_4, w1_scale, dev, d)
    g2 = check_weight("fc2", w2_4, w2_scale, dev, hdim)
    if w2_4.shape[0] != d or block_h % g2:
        raise ValueError(f"fc2 {tuple(w2_4.shape)} with group {g2} does not "
                         f"fit D={d}, block_h={block_h}")
    build.check_operand("fc1 bias", b1, dev, _FLOATS, (hdim,))
    build.check_operand("fc2 bias", b2, dev, (b1.dtype,), (d,))
    build.check_operand("residual", residual, dev, (out_dtype,), (m, d))
    out = torch.empty((m, d), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    n_h = hdim // block_h
    if groups is None:
        groups = mlp_hidden_groups(
            -(-m // BLOCK_ROWS), n_h,
            torch.cuda.get_device_properties(dev).multi_processor_count)
    if groups < 1 or n_h % groups:
        raise ValueError(f"{n_h} hidden blocks do not split into {groups} "
                         "groups")
    part = (torch.empty((groups, m, d), dtype=torch.float32, device=dev)
            if groups > 1 else None)
    rc = build.library().tae_int4_mlp_fwd(
        xq.data_ptr(), sx.data_ptr(), w1_4.data_ptr(), w1_scale.data_ptr(),
        b1.data_ptr(), w2_4.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(),
        residual.data_ptr(), out.data_ptr(), m, d, hdim, g1, g2,
        build.dtype_code(out_dtype), build.dtype_code(b1.dtype),
        build.ptr(part), groups, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_int4_mlp_fwd")
    int4_mlp.launches += 1
    return out


int4_mlp.launches = 0
