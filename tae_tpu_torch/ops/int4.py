"""int4 weight quantization, w4a8 with group-wise scales (counterpart of
``tae_tpu/ops/int4.py``).

Small-batch serving of the widest configs streams every weight once per
request, so weight bytes set the latency; this path stores the four linears
of every transformer block as packed int4:

  * weights: static symmetric int4 codes in [-7, 7] with group-wise fp32
    scales, one per (group of ``G`` consecutive inputs, output channel),
    ``scale = max(amax / 7, 1e-12)``. Codes and scales equal the JAX
    package's exactly. A group never straddles the middle of K (the JAX
    layout's plane boundary), so ``G`` divides K/2: :func:`group_size`.
  * packing: two codes per byte, stored torch-style and K-contiguous,
    ``(N, K/2)`` uint8. **The byte layout is the port's own**
    (``"k32-twos"``): within every run of 32 consecutive inputs, byte ``j``
    holds input ``j`` in its low nibble and input ``16 + j`` in its high
    nibble, two's complement. That is the operand order of the H100's
    int8 tensor-core instruction (``mma.sync.m16n8k32``): one 32-bit word
    of packed bytes decodes, with a shift and two masks, into the two
    operand registers a thread feeds it, so the weight stays packed all the
    way into registers (:mod:`tae_tpu_torch.ops.cuda.int4_matmul` has the
    details). The JAX package's nibble planes and offset-8 bytes answer its
    own target's rules. :func:`~tae_tpu_torch.ops.cuda.int4_matmul.pack_int4`
    and :func:`unpack_int4` are the one packer and the one unpacker;
    :mod:`tae_tpu_torch.ckpt.bridge` repacks a JAX tree.
  * activations: dynamic per-row int8, exactly as in the int8 path.
  * products: int8 x int8 -> int32 per group, summed over the groups in
    fp32 (exact terms: a group sum is below 256 * 127 * 7 < 2^24).

Layer selection (:func:`quantize_params_int4_`): the four linears of every
block go int4 where :func:`int4_ok` (else int8); every linear outside the
blocks takes the int8 form; ``patch_embed`` stays float.

Forward-only (serving), like the int8 path: the dispatchers raise on a
tensor that requires a gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.attention import resolve_backend
from tae_tpu_torch.ops.cuda import build, int4_block, int4_matmul
from tae_tpu_torch.ops.cuda.int4_matmul import (LAYOUT, pack_int4,  # noqa: F401
                                                unpack_int4)
from tae_tpu_torch.ops.cuda.int8_block import DEFAULT_BLOCK_H

#: largest group (inputs sharing one scale per output channel)
GROUP = 256


def group_size(half_k: int, cap: int = GROUP) -> int:
    """The largest multiple of 128 up to ``cap`` that divides ``half_k``
    (half the input dim: groups do not straddle the middle of K), else
    ``half_k`` itself. The JAX package's rule, so that both choose the same
    groups."""
    b = max(128, (cap // 128) * 128)
    while b >= 128:
        if half_k % b == 0:
            return b
        b -= 128
    return half_k


def int4_ok(in_dim: int) -> bool:
    """Whether a linear of ``in_dim`` inputs takes the int4 form: an even K
    whose half is a multiple of 128, decided from the shape alone."""
    return in_dim % 2 == 0 and (in_dim // 2) % 128 == 0


def quantize_weight_int4(w: torch.Tensor, group: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, K) float weight, torch layout -> (packed (N, K/2) uint8, (K/G, N)
    fp32 scales). K must be even and the group divide K/2."""
    n, k = w.shape
    if k % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {k}")
    g = group or group_size(k // 2)
    if (k // 2) % g:
        raise ValueError(f"group {g} must divide half the input dim {k // 2}")
    w32 = w.float().t().reshape(k // g, g, n)
    scale = (w32.abs().amax(dim=1) / 7.0).clamp_min(1e-12)
    q = torch.round(w32 / scale[:, None]).clamp(-7, 7)
    return pack_int4(q.reshape(k, n).t().to(torch.int8)), scale


def dequantize_int4(w4: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Packed int4 + group scales -> (N, K) fp32 weight, torch layout."""
    group = int4_matmul.group_of(w4, w_scale)
    q = unpack_int4(w4).float()                                  # (N, K)
    return q * w_scale.float().repeat_interleave(group, dim=0).t()


def int4_linear(x: torch.Tensor, w4: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None = None, backend: str | None = None,
                x_scale: torch.Tensor | None = None,
                residual: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (..., K) against a packed int4 weight (N, K/2) with group scales
    (K/G, N). The contract of :func:`tae_tpu_torch.ops.int8.int8_linear`:
    ``x_scale`` (..., 1) for an already-int8 x (a float x is quantized per
    row first, in plain PyTorch, as the JAX wrapper does ahead of its
    kernel), ``residual`` (..., N) added in the epilogue; the output dtype
    defaults to x's for a float x and to bfloat16 for an int8 x."""
    build.refuse_grad("int4_linear", x, x_scale, bias, residual)
    if x_scale is None:
        if not x.is_floating_point():
            raise TypeError("an int8 x needs its x_scale")
        out_dtype = out_dtype or x.dtype
        x, x_scale = int8.quantize_rows(x)
    else:
        if x.dtype != torch.int8:
            raise TypeError("x_scale requires an already-quantized int8 x")
        out_dtype = out_dtype or torch.bfloat16
    lead, k = x.shape[:-1], x.shape[-1]
    n = w4.shape[0]
    res2 = None if residual is None else residual.reshape(-1, n)
    fn = (int4_matmul.int4_matmul_fused
          if resolve_backend(backend, x) == "kernel"
          else int4_matmul.int4_matmul_reference)
    y = fn(x.reshape(-1, k), x_scale.reshape(-1, 1), w4, w_scale, bias, res2,
           out_dtype)
    return y.reshape(*lead, n)


def int4_mlp(xq: torch.Tensor, sx: torch.Tensor, fc1, fc2,
             residual: torch.Tensor, block_h: int = DEFAULT_BLOCK_H,
             out_dtype: torch.dtype = torch.bfloat16,
             backend: str | None = None) -> torch.Tensor:
    """``residual + fc2(gelu(fc1(xq)))`` for two int4 linears (modules with
    ``w4``, ``w4_scale`` and ``bias``), fused; see
    :func:`tae_tpu_torch.ops.cuda.int4_block.int4_mlp`."""
    build.refuse_grad("int4_mlp", sx, fc1.bias, fc2.bias, residual)
    fn = (int4_block.int4_mlp if resolve_backend(backend, xq) == "kernel"
          else int4_block.int4_mlp_reference)
    return fn(xq, sx, fc1.w4, fc1.w4_scale, fc1.bias, fc2.w4, fc2.w4_scale,
              fc2.bias, residual, block_h, out_dtype)


@torch.no_grad()
def quantize_params_int4_(model: nn.Module,
                          skip: tuple[str, ...] = ("patch_embed",),
                          block_h: int = DEFAULT_BLOCK_H,
                          fill: bool = True) -> nn.Module:
    """Rewrite the linears of ``model`` to their quantized forms, in place:
    the four linears of every transformer block become ``Q4Linear`` where
    :func:`int4_ok` (else ``QLinear``), every other linear ``QLinear``;
    sub-modules named in ``skip`` stay float (the int4 mode never quantizes
    the patch embedding). ``fill=False`` only builds the layout, for a
    ``load_state_dict`` to fill. Freezes the model, as
    :func:`tae_tpu_torch.ops.int8.quantize_params_` does."""
    from tae_tpu_torch.nn import vit

    for blk in model.modules():
        if not isinstance(blk, vit.Block):
            continue
        for owner, name in ((blk.attn, "qkv"), (blk.attn, "proj"),
                            (blk.mlp, "fc1"), (blk.mlp, "fc2")):
            lin = getattr(owner, name)
            if isinstance(lin, vit.Linear) and int4_ok(lin.weight.shape[1]):
                setattr(owner, name, vit.Q4Linear.from_float(lin, fill))
    return int8.quantize_params_(model, skip=skip, block_h=block_h, fill=fill)
