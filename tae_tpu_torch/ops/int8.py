"""int8 quantized inference, w8a8 with dynamic activation scales (counterpart
of ``tae_tpu/ops/int8.py``).

  * weights: static symmetric per-output-channel int8
    (``w_q = round(w / s_w)``, one fp32 scale per output channel), stored
    torch-style ``(out, in)``;
  * activations: dynamic symmetric per-row int8;
  * products in int8 -> int32, rescaled by ``s_x * s_w``.

:func:`quantize_params_` rewrites the ``Linear`` layers of a float model to
:class:`tae_tpu_torch.nn.vit.QLinear` in place; everything else (LayerNorm,
position embeddings, softmax) stays in the compute dtype. The dispatchers
here pick the hand-written CUDA kernels for CUDA tensors and the plain
versions for CPU tensors or an explicit ``backend="reference"``, as
:mod:`tae_tpu_torch.ops.layernorm` does.

The int8 path is forward-only (serving). Rounding to codes has no useful
derivative, so the dispatchers raise on a tensor that requires a gradient,
whichever backend would run, instead of handing back outputs that autograd
cannot see through.

The tile planners of the JAX package (``vmem_limit``, ``_plan_blocks``,
``_ln_chain_plan``, ``unstack_blocks``) answer questions only its target
asks and have no counterpart here; the one shape rule the kernels need is
:func:`tae_tpu_torch.ops.cuda.int8_matmul.ln_chain_rows`.
"""

from __future__ import annotations

import torch
from torch import nn

from tae_tpu_torch.ops.attention import resolve_backend
from tae_tpu_torch.ops.cuda import build, int8_block, int8_matmul
from tae_tpu_torch.ops.cuda.int8_block import DEFAULT_BLOCK_H

QUANTIZATIONS = ("int8", "int4")


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight -> (int8 weight (out, in), (out,) fp32
    per-output-channel scales)."""
    w32 = w.float()
    scale = (w32.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    wq = torch.round(w32 / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return wq, scale


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 scales of a float x (..., K): max(amax / 127,
    1e-12), the amax taken in x's dtype (exact); fp32 (..., 1)."""
    return (x.abs().amax(dim=-1, keepdim=True).float() / 127.0).clamp_min(1e-12)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of a float activation x (..., K): the pass the
    JAX package runs ahead of its matmul kernel for a float input
    (``prequantize=True``): :func:`row_scales`, the division in fp32.
    Returns (int8 (..., K), fp32 scales (..., 1))."""
    sx = row_scales(x)
    xq = torch.round(x.float() / sx).clamp(-127.0, 127.0).to(torch.int8)
    return xq, sx


def q8_block(n: int, cap: int = 512) -> int:
    """Columns per scale of the ``q8_out`` output of an N-wide product: the
    largest multiple of 128 up to ``cap`` that divides N, else N (the JAX
    package's ``_block(n, 512)``, part of the contract with the int8-input
    attention, whose head dim must divide it)."""
    b = max(128, (cap // 128) * 128)
    while b >= 128:
        if n % b == 0:
            return b
        b -= 128
    return n


def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-6, backend: str | None = None):
    """LayerNorm + per-row int8 of x (M, D): (int8 (M, D), fp32 (M, 1))."""
    build.refuse_grad("ln_quant", x, weight, bias)
    if resolve_backend(backend, x) == "kernel":
        return int8_block.ln_quant(x, weight, bias, eps)
    return int8_block.ln_quant_reference(x, weight, bias, eps)


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None = None, backend: str | None = None,
                x_scale: torch.Tensor | None = None,
                residual: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None, q8_out: bool = False,
                ln_out=None, prequantize: bool = True,
                block_n: int | None = None):
    """x (..., in) against an int8 weight (out, in).

    ``x_scale``: (..., 1) per-row scales of an already-int8 x (pair with
    :func:`ln_quant`); a float x is quantized per row first, by a separate
    pass (:func:`quantize_rows`) or, with ``prequantize=False``, inside the
    kernel from its row scales (x * (1 / s), the JAX package's in-kernel
    form). ``residual``: (..., out), added in the epilogue. ``ln_out =
    (gamma, beta, eps)`` asks for the chained LayerNorm + int8 of the output
    as well: the result is ``(y, yq, ys)``, and ``(y, None, None)`` where
    :func:`~tae_tpu_torch.ops.cuda.int8_matmul.ln_chain_rows` says the
    output row is too wide to chain; the caller then runs :func:`ln_quant`.
    ``q8_out``: the output leaves as int8, ``(yq (..., out), ys (out /
    block_n, M, 1))`` with one scale per row and block of ``block_n``
    columns (default :func:`q8_block`), the input of the int8-input
    attention. The output dtype defaults to x's for a float x and to
    bfloat16 for an int8 x."""
    build.refuse_grad("int8_linear", x, x_scale, bias, residual,
                      *(ln_out[:2] if ln_out is not None else ()))
    if q8_out and ln_out is not None:
        raise ValueError("ln_out and q8_out exclude each other")
    if q8_out or (not prequantize and x_scale is None):
        return _int8_linear_rows(x, w_q, w_scale, bias, backend, x_scale,
                                 residual, out_dtype, q8_out, block_n,
                                 prequantize)
    if x_scale is None:
        if not x.is_floating_point():
            raise TypeError("an int8 x needs its x_scale")
        out_dtype = out_dtype or x.dtype
        x, x_scale = quantize_rows(x)
    else:
        if x.dtype != torch.int8:
            raise TypeError("x_scale requires an already-quantized int8 x")
        out_dtype = out_dtype or torch.bfloat16
    lead, k = x.shape[:-1], x.shape[-1]
    n = w_q.shape[0]
    x2, sx2 = x.reshape(-1, k), x_scale.reshape(-1, 1)
    res2 = None if residual is None else residual.reshape(-1, n)
    chain = ln_out is not None and int8_matmul.ln_chain_rows(n) is not None
    fn = (int8_matmul.int8_matmul_fused
          if resolve_backend(backend, x) == "kernel"
          else int8_matmul.int8_matmul_reference)
    y = fn(x2, sx2, w_q, w_scale, bias, res2, out_dtype,
           ln_out if chain else None)
    if chain:
        y, yq, ys = y
        return (y.reshape(*lead, n), yq.reshape(*lead, n),
                ys.reshape(*lead, 1))
    y = y.reshape(*lead, n)
    return (y, None, None) if ln_out is not None else y


def _int8_linear_rows(x, w_q, w_scale, bias, backend, x_scale, residual,
                      out_dtype, q8_out: bool, block_n: int | None,
                      prequantize: bool):
    """int8_linear through K4's int8_matmul_rows entry (q8_out, or a float
    x quantized by the kernel's first pass)."""
    if x_scale is None:
        if not x.is_floating_point():
            raise TypeError("an int8 x needs its x_scale")
        out_dtype = out_dtype or x.dtype
        if prequantize:
            x, x_scale = quantize_rows(x)
        else:
            x_scale = row_scales(x)
    elif x.dtype != torch.int8:
        raise TypeError("x_scale requires an already-quantized int8 x")
    lead, k = x.shape[:-1], x.shape[-1]
    n = w_q.shape[0]
    block = (block_n or q8_block(n)) if q8_out else None
    fn = (int8_matmul.int8_matmul_rows
          if resolve_backend(backend, x) == "kernel"
          else int8_matmul.int8_matmul_rows_reference)
    y = fn(x.reshape(-1, k), x_scale.reshape(-1, 1), w_q, w_scale, bias,
           None if residual is None else residual.reshape(-1, n),
           out_dtype or torch.bfloat16, block)
    if q8_out:
        yq, ys = y
        return yq.reshape(*lead, n), ys
    return y.reshape(*lead, n)


def int8_mlp(xq: torch.Tensor, sx: torch.Tensor, fc1, fc2,
             residual: torch.Tensor, block_h: int = DEFAULT_BLOCK_H,
             out_dtype: torch.dtype = torch.bfloat16, ln_next=None,
             backend: str | None = None):
    """``residual + fc2(gelu(fc1(xq)))`` for two quantized linears (modules
    with ``w_q``, ``w_scale`` and ``bias``), fused; see
    :func:`tae_tpu_torch.ops.cuda.int8_block.int8_mlp`."""
    build.refuse_grad("int8_mlp", sx, fc1.bias, fc2.bias, residual,
                      *(ln_next[:2] if ln_next is not None else ()))
    fn = (int8_block.int8_mlp if resolve_backend(backend, xq) == "kernel"
          else int8_block.int8_mlp_reference)
    return fn(xq, sx, fc1.w_q, fc1.w_scale, fc1.bias, fc2.w_q, fc2.w_scale,
              fc2.bias, residual, block_h, out_dtype, ln_next)


# ---------------------------------------------------------------------------
# model rewrites: equalize -> quantize
# ---------------------------------------------------------------------------

def _equalize_pair(norm: nn.Module, lin: nn.Module, alpha: float,
                   x_amax: torch.Tensor | None = None) -> None:
    g, b, w = norm.weight, norm.bias, lin.weight           # w (out, in)
    if x_amax is not None:
        ax = x_amax.to(device=g.device, dtype=torch.float32)
    else:
        ax = g.float().abs() + b.float().abs()
    aw = w.float().abs().amax(dim=0)                       # (in,)
    s = ax ** alpha / aw.clamp_min(1e-12) ** (1.0 - alpha)
    ok = (ax > 1e-6) & (aw > 1e-12) & torch.isfinite(s)
    s = torch.where(ok, s.clamp(1e-4, 1e4), torch.ones_like(s))
    g.copy_((g.float() / s).to(g.dtype))
    b.copy_((b.float() / s).to(b.dtype))
    w.copy_((w.float() * s[None, :]).to(w.dtype))


@torch.no_grad()
def equalize_params_(model: nn.Module, alpha: float = 0.5,
                     act_amax: dict[str, torch.Tensor] | None = None
                     ) -> nn.Module:
    """SmoothQuant-style activation-outlier equalization of a float TAE, in
    place, before :func:`quantize_params_`. Every pre-LN pair — (norm1 ->
    attn.qkv) and (norm2 -> mlp.fc1) in each block, (norm -> dict_proj) and
    (decoder_norm -> decoder_pred) — is rewritten with per-input-channel
    factors ``s``::

        gamma' = gamma / s      beta' = beta / s      W'[:, c] = s_c * W[:, c]

    which is exact in real arithmetic, while the per-row activation
    quantizer sees a flattened channel range. ``s_c = ax_c^alpha /
    aw_c^(1 - alpha)`` with ``aw`` the weight's per-input-channel amax and
    ``ax`` the activation's per-channel amax: measured, from ``act_amax``
    (``{linear name: (in,) amax}``, the output of
    :func:`tae_tpu_torch.calibrate.ln_amax`) where it holds the pair's
    linear, else estimated from the LN affine, ``|gamma| + |beta|`` (the
    affine predicts the outlier channels without calibration data).
    Degenerate channels keep ``s = 1``."""
    from tae_tpu_torch.calibrate import taps

    act_amax = act_amax or {}
    for norm, key in taps(model):
        _equalize_pair(norm, model.get_submodule(key), alpha,
                       act_amax.get(key))
    return model


@torch.no_grad()
def quantize_params_(model: nn.Module, skip: tuple[str, ...] = ("patch_embed",),
                     block_h: int = DEFAULT_BLOCK_H,
                     fill: bool = True) -> nn.Module:
    """Replace every ``Linear`` (and the patch projection) of ``model`` by a
    ``QLinear`` holding its int8 form, in place; sub-modules named in
    ``skip`` stay float. The default keeps ``patch_embed`` in the float
    path; ``skip=()`` quantizes it too, for deployments that feed
    pre-patchified rows. ``block_h`` is recorded on every MLP (see
    :mod:`tae_tpu_torch.ops.cuda.int8_block`). ``fill=False`` only builds
    the quantized layout, for a ``load_state_dict`` to fill.

    The rewrite is for serving: it freezes every parameter of ``model``
    (``requires_grad=False``). The int8 kernels are forward-only and raise
    on a tensor that requires a gradient."""
    from tae_tpu_torch.nn import vit

    def walk(module: nn.Module) -> None:
        for name, child in module.named_children():
            if name in skip:
                continue
            if isinstance(child, (vit.Linear, vit.PatchProj)):
                setattr(module, name, vit.QLinear.from_float(child, fill))
            else:
                walk(child)
        if isinstance(module, vit.Mlp) and isinstance(
                module.fc1, (vit.QLinear, vit.Q4Linear)):
            hdim = module.fc1.bias.shape[0]
            if hdim % block_h:
                raise ValueError(f"MLP hidden dim {hdim} is not a multiple of "
                                 f"block_h {block_h}")
            module.block_h = block_h

    walk(model)
    return model.requires_grad_(False)


def prepare_serving_(model: nn.Module, quantization: str,
                     equalize: float | bool = 0.0,
                     act_amax: dict[str, torch.Tensor] | None = None,
                     patch_input: bool = False,
                     block_h: int = DEFAULT_BLOCK_H) -> nn.Module:
    """The serving rewrite, in order: (optional) equalization -> int8 or
    int4 quantization. ``equalize``: falsy = off, True = alpha 0.5, a number
    = alpha; ``act_amax``: measured activation statistics for it (see
    :func:`equalize_params_`). ``patch_input=True`` declares pre-patchified
    (B, N, C*p*p) requests, where the patch embedding is a plain matmul, and
    int8 quantizes it too; int4 ignores it (its patch embedding stays float,
    as in the JAX package)."""
    if quantization not in QUANTIZATIONS:
        raise ValueError(f"unknown quantization mode {quantization!r}")
    if equalize:
        equalize_params_(model, 0.5 if equalize is True else float(equalize),
                         act_amax)
    if quantization == "int4":
        from tae_tpu_torch.ops.int4 import quantize_params_int4_

        return quantize_params_int4_(model, block_h=block_h)
    skip = () if patch_input else ("patch_embed",)
    return quantize_params_(model, skip=skip, block_h=block_h)
