"""K13 ``int4_mlp``: the fused w4a8 MLP of the int4 serving block
(counterpart of ``tae_tpu/ops/pallas/int4_block.py::int4_mlp``; source
``tae_tpu_torch/csrc/int4_block.cu``) and its plain version.

``residual + fc2(gelu_tanh(fc1(xq)))`` with both weights in the packed int4
layout of :mod:`tae_tpu_torch.ops.cuda.int4_matmul`; the (M, 4D) hidden
activation is requantized per (row, block of ``block_h`` hidden columns).

``block_h`` is part of the numerics, as in ``int8_mlp``: one int8 scale per
(row, hidden block). The port uses one value for both fused MLPs,
:data:`~tae_tpu_torch.ops.cuda.int8_block.DEFAULT_BLOCK_H` (256): the
kernel's fc1 tile is one hidden block wide, and at 256 columns one hidden
block is one fc2 scale group. The JAX package defaults to 512; the tests pin
it to the port's value.

The kernel is K5's three device launches (fc1 with GELU and requantize in
its epilogue, fc2, and with more than one hidden group a finish pass),
counted as one launch, over workspaces this module allocates;
:func:`mlp4_fc1_reference`, :func:`mlp4_fc2_reference` and
:func:`mlp4_finish_reference` are their plain versions and compose into
:func:`int4_mlp_reference`.

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

_FLOATS = (torch.float32, torch.bfloat16)
#: the hidden block the kernel is written for
KERNEL_BLOCK_H = DEFAULT_BLOCK_H
#: fc1's tiles (rows, columns: one hidden block), in the order of
#: csrc/int4_block.cu's kFc1Many, kFc1Few
FC1_TILES = ((32, 256), (16, 256))
#: fc2's tiles (rows, columns): kFc2Many, kFc2Few
FC2_TILES = ((64, 64), (16, 64))
#: waves of fc2 blocks the hidden groups may fill: its few-row tiles are
#: small (64 and 128 threads), several share an SM, and its K (the hidden
#: dim) is long, so splitting it further pays until this many blocks per SM
FC2_WAVES = 4


def mlp4_tiles(m: int, d: int, hdim: int, sms: int) -> tuple[int, int, int]:
    """(fc1 tile, fc2 tile, hidden groups) of the kernel for M rows at width
    ``d`` and hidden dim ``hdim`` on ``sms`` SMs: indices into
    :data:`FC1_TILES` and :data:`FC2_TILES`, and fc2's split of the hidden
    blocks of 256, by K5's rule (:func:`~tae_tpu_torch.ops.cuda.
    int8_block.mlp_tiles`) without its 64 x 128 fc2 tile, which measured
    slower (H100: 1.0781 against 1.0544 ms at p16): fc1 takes 16 rows up to
    M = 64, else 32; fc2 16 x 64 tiles up to M = 64, else 64 x 64; the
    groups are :func:`~tae_tpu_torch.ops.cuda.int8_block.mlp_hidden_groups`
    of fc2's output tiles on :data:`FC2_WAVES` times the SMs. Raises on
    shapes the kernel does not take (D a multiple of 64, the hidden dim of
    256)."""
    if m < 1 or d < 64 or d % 64 or hdim < KERNEL_BLOCK_H \
            or hdim % KERNEL_BLOCK_H:
        raise ValueError(f"int4_mlp takes D a multiple of 64 and a hidden dim "
                         f"of {KERNEL_BLOCK_H}, got M={m}, D={d}, "
                         f"hidden={hdim}")
    fc1 = fc2 = 1 if m <= 64 else 0
    bm, bn = FC2_TILES[fc2]
    groups = mlp_hidden_groups(-(-m // bm) * -(-d // bn),
                               hdim // KERNEL_BLOCK_H, FC2_WAVES * sms)
    return fc1, fc2, groups


def _check_block_h(hdim: int, block_h: int, g2: int) -> int:
    """The hidden blocks of ``block_h`` columns in ``hdim``; raises unless
    they tile it and fc2's group ``g2`` divides one."""
    if block_h < 1 or hdim % block_h or block_h % g2:
        raise ValueError(f"hidden dim {hdim} is not a multiple of block_h "
                         f"{block_h}, or fc2's group {g2} does not divide it")
    return hdim // block_h


def mlp4_fc1_reference(xq: torch.Tensor, sx: torch.Tensor,
                       w1_4: torch.Tensor, w1_scale: torch.Tensor,
                       b1: torch.Tensor, block_h: int = DEFAULT_BLOCK_H
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fc1 launch: per hidden block of ``block_h``
    columns ``h = gelu(sum_g float(xq_g . w1_g^T) * s1_g * sx + b1)``, one
    scale per row over the block, the int8 codes. Returns (hq (M, H) int8,
    sh (H / block_h, M) fp32)."""
    hdim = w1_4.shape[0]
    if block_h < 1 or hdim % block_h:
        raise ValueError(f"hidden dim {hdim} is not a multiple of block_h "
                         f"{block_h}")
    q1, s1 = unpack_int4(w1_4), w1_scale.float()
    g1 = group_of(w1_4, w1_scale)
    sx = sx.reshape(-1, 1)
    hq, sh = [], []
    for h0 in range(0, hdim, block_h):
        sl = slice(h0, h0 + block_h)
        h = group_products(xq, q1[sl], s1[:, sl], g1)
        h = gelu_tanh(h * sx + b1[sl].float())
        s = (h.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
        hq.append(torch.round(h * (1.0 / s)).clamp(-127.0, 127.0)
                  .to(torch.int8))
        sh.append(s.reshape(-1))
    return torch.cat(hq, dim=1), torch.stack(sh)


def mlp4_fc2_reference(hq: torch.Tensor, sh: torch.Tensor,
                       w2_4: torch.Tensor, w2_scale: torch.Tensor,
                       block_h: int = DEFAULT_BLOCK_H,
                       groups: int = 1) -> torch.Tensor:
    """Plain version of the fc2 launch: the hidden blocks dealt evenly to
    ``groups``, each group's fp32 accumulator ``acc = acc + part_b * sh_b``
    over its blocks in ascending order, ``part_b`` the block's group sum
    ``sum_g float(hq_g . w2_g^T) * s2_g``. Returns (groups, M, D) fp32."""
    q2, s2 = unpack_int4(w2_4), w2_scale.float()
    g2 = group_of(w2_4, w2_scale)
    n_h = _check_block_h(q2.shape[1], block_h, g2)
    if groups < 1 or n_h % groups:
        raise ValueError(f"{n_h} hidden blocks do not split into {groups} "
                         "groups")
    per = n_h // groups
    parts = []
    for run in range(groups):
        acc = torch.zeros((hq.shape[0], q2.shape[0]), dtype=torch.float32,
                          device=hq.device)
        for hb in range(run * per, (run + 1) * per):
            sl = slice(hb * block_h, (hb + 1) * block_h)
            gs = slice(hb * block_h // g2, (hb + 1) * block_h // g2)
            acc = acc + group_products(hq[:, sl], q2[:, sl], s2[gs], g2) \
                * sh[hb].reshape(-1, 1)
        parts.append(acc)
    return torch.stack(parts)


def mlp4_finish_reference(part: torch.Tensor, b2: torch.Tensor,
                          residual: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Plain version of the finish pass (of fc2's epilogue with one group):
    the groups' accumulators added in order, ``+ b2 + residual`` in fp32,
    cast once."""
    total = part[0]
    for g in range(1, part.shape[0]):
        total = total + part[g]
    return (total + b2.float() + residual.float()).to(out_dtype)


def int4_mlp_reference(xq: torch.Tensor, sx: torch.Tensor, w1_4: torch.Tensor,
                       w1_scale: torch.Tensor, b1: torch.Tensor,
                       w2_4: torch.Tensor, w2_scale: torch.Tensor,
                       b2: torch.Tensor, residual: torch.Tensor,
                       block_h: int = DEFAULT_BLOCK_H,
                       out_dtype: torch.dtype = torch.bfloat16,
                       groups: int = 1) -> torch.Tensor:
    """Plain version of the kernel: the three plain halves in a row. xq (M,
    D) int8 with sx (M, 1); w1_4 (H, D/2) and w2_4 (D, H/2) packed, with
    (D/G1, H) and (H/G2, D) group scales; residual (M, D) float. The order
    of the sums is the module's; ``groups`` is the number of runs the hidden
    blocks are dealt to (the kernel's grid split for few rows)."""
    _check_block_h(w1_4.shape[0], block_h, group_of(w2_4, w2_scale))
    hq, sh = mlp4_fc1_reference(xq, sx, w1_4, w1_scale, b1, block_h)
    part = mlp4_fc2_reference(hq, sh, w2_4, w2_scale, block_h, groups)
    return mlp4_finish_reference(part, b2, residual, out_dtype)


def int4_mlp(xq: torch.Tensor, sx: torch.Tensor, w1_4: torch.Tensor,
             w1_scale: torch.Tensor, b1: torch.Tensor, w2_4: torch.Tensor,
             w2_scale: torch.Tensor, b2: torch.Tensor, residual: torch.Tensor,
             block_h: int = DEFAULT_BLOCK_H,
             out_dtype: torch.dtype = torch.bfloat16,
             groups: int | None = None) -> torch.Tensor:
    """``residual + fc2(gelu(fc1(xq)))`` with packed int4 weights, one
    counted launch (two or three on the device): y (M, D) of
    ``out_dtype``. Shapes as :func:`int4_mlp_reference`. ``groups=None``
    lets the kernel deal the hidden blocks to as many runs as fill the card
    (:func:`mlp4_tiles`; the plain version on a CPU tensor takes 1). On
    CUDA ``block_h`` must be 256, both scale groups multiples of 64 with
    fc2's dividing 256, D a multiple of 64, ``residual`` of ``out_dtype``
    and everything contiguous; anything else raises."""
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
    fc1, fc2, auto = mlp4_tiles(
        m, d, hdim, torch.cuda.get_device_properties(dev).multi_processor_count)
    groups = auto if groups is None else groups
    if groups < 1 or n_h % groups:
        raise ValueError(f"{n_h} hidden blocks do not split into {groups} "
                         "groups")
    hq = torch.empty((m, hdim), dtype=torch.int8, device=dev)
    sh = torch.empty((n_h, m), dtype=torch.float32, device=dev)
    part = (torch.empty((groups, m, d), dtype=torch.float32, device=dev)
            if groups > 1 else None)
    rc = build.library().tae_int4_mlp_fwd(
        xq.data_ptr(), sx.data_ptr(), w1_4.data_ptr(), w1_scale.data_ptr(),
        b1.data_ptr(), w2_4.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(),
        residual.data_ptr(), out.data_ptr(), m, d, hdim, g1, g2,
        build.dtype_code(out_dtype), build.dtype_code(b1.dtype),
        hq.data_ptr(), sh.data_ptr(), build.ptr(part), groups, fc1, fc2,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_int4_mlp_fwd")
    int4_mlp.launches += 1
    return out


int4_mlp.launches = 0
