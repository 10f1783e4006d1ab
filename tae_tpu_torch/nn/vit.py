"""ViT building blocks as ``nn.Module``s (counterpart of ``tae_tpu/nn/vit.py``,
float path and the fused int8 serving block).

Conventions:
  * Linear weights are stored torch-style (out, in); the fused qkv
    projection is one (3·dim, dim) weight packed [q|k|v] along its output.
  * Each layer computes in the dtype of the activations it receives and
    casts its parameters to it (the JAX package's ``cast_to_compute``).
  * GELU is exact (erf) in fp32 and the tanh approximation in bf16, where
    its error is below bf16's rounding step.
  * LayerNorm statistics run in fp32 (:mod:`tae_tpu_torch.ops.layernorm`).
  * ``backend`` is None (resolved from the tensor's device), ``"kernel"`` or
    ``"reference"``; ``serving=True`` (the Tokenizer's inference path only)
    selects the clamped softmax.

  * A model quantized by :func:`tae_tpu_torch.ops.int8.quantize_params_`
    holds :class:`QLinear` layers, one quantized by
    :func:`tae_tpu_torch.ops.int4.quantize_params_int4_` :class:`Q4Linear`
    layers in its blocks (and ``QLinear`` wherever the shape rules out
    int4); a block whose linears are all quantized, in either form, takes
    the fused serving forward (:meth:`Block.forward_int8`), any other block
    the float forward. A qk_norm block always takes the float forward, as
    in the JAX package: its quantized linears dispatch one by one and its
    attention stays float.
  * ``qk_norm=True`` (reference tae.py:68-69) adds a LayerNorm over each
    head's dh columns of q and of k (``attn.q_norm`` / ``attn.k_norm``);
    the heads are split and attention runs on unpacked (B, H, N, dh)
    operands (:func:`tae_tpu_torch.ops.attention.attention`, K16 / K17).

Parameters are allocated frozen (the serving face builds most models); a
model built with ``trainable=True`` (:class:`tae_tpu_torch.models.tae.TAE`)
requires a gradient on every parameter.
:func:`tae_tpu_torch.ops.int8.quantize_params_` freezes the model it rewrites,
and the int8 kernels refuse tensors that require a gradient. ``remat=True`` on
:func:`blocks_apply` recomputes each float block in the backward pass
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` around the
block body). The JAX package's ``unroll`` and ``scan`` have no meaning for an
eager forward and are dropped.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tae_tpu_torch.nn import init as tinit
from tae_tpu_torch.ops import int4, int8
from tae_tpu_torch.ops.attention import (QKV_Q8_MIN_TOKENS, attention,
                                         attention_route, packed_attention,
                                         qkv_i8_attention)
from tae_tpu_torch.ops.layernorm import layer_norm
from tae_tpu_torch.ops.patchify import extract_patches


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    dim: int
    num_heads: int
    qkv_bias: bool = True
    qk_norm: bool = False
    ln_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    dim: int
    num_heads: int
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_norm: bool = False
    ln_eps: float = 1e-6

    @property
    def attn(self) -> AttentionConfig:
        return AttentionConfig(self.dim, self.num_heads, self.qkv_bias,
                               self.qk_norm, self.ln_eps)

    @property
    def mlp_hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)


def empty_param(shape, device, dtype) -> nn.Parameter:
    """Frozen as allocated; a model built with ``trainable=True`` turns the
    gradient on for all its parameters."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# linear / layernorm
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """y = x Wᵀ + b with W stored (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = empty_param((out_dim, in_dim), device, dtype)
        self.bias = empty_param((out_dim,), device, dtype) if bias else None

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.weight.copy_(tinit.xavier_uniform(generator, self.weight.shape))
        if self.bias is not None:
            self.bias.copy_(tinit.zeros(self.bias.shape, device=generator.device))

    def forward(self, x: torch.Tensor, backend: str | None = None
                ) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class QLinear(nn.Module):
    """A ``Linear`` in its int8 serving form: weight codes ``w_q`` (out, in)
    int8 and per-output-channel scales ``w_scale`` (out,) fp32 as buffers,
    the bias as before. A float input is quantized per row on the fly."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.register_buffer("w_q", torch.empty((out_dim, in_dim),
                                                device=device, dtype=torch.int8))
        self.register_buffer("w_scale", torch.empty((out_dim,), device=device,
                                                    dtype=torch.float32))
        self.bias = empty_param((out_dim,), device, dtype) if bias else None

    @classmethod
    @torch.no_grad()
    def from_float(cls, lin: nn.Module, fill: bool = True) -> "QLinear":
        """From a ``Linear`` or a ``PatchProj`` (whose conv-shaped weight is
        applied as the matrix (E, C*p*p))."""
        w = lin.weight.reshape(lin.weight.shape[0], -1)
        q = cls(w.shape[1], w.shape[0], lin.bias is not None, w.device,
                w.dtype)
        if fill:
            wq, scale = int8.quantize_weight(w)
            q.w_q.copy_(wq)
            q.w_scale.copy_(scale)
            if lin.bias is not None:
                q.bias.copy_(lin.bias)
        return q

    def forward(self, x: torch.Tensor, backend: str | None = None, **kw):
        """``kw``: ``x_scale``, ``residual``, ``out_dtype``, ``ln_out`` of
        :func:`tae_tpu_torch.ops.int8.int8_linear`."""
        return int8.int8_linear(x, self.w_q, self.w_scale, self.bias,
                                backend=backend, **kw)


class Q4Linear(nn.Module):
    """A ``Linear`` in its int4 (w4a8) serving form: packed codes ``w4``
    (out, in / 2) uint8 in the layout of
    :mod:`tae_tpu_torch.ops.cuda.int4_matmul` and group scales ``w4_scale``
    (in / G, out) fp32 as buffers, the bias as before. A float input is
    quantized per row on the fly."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        groups = in_dim // int4.group_size(in_dim // 2)
        self.register_buffer("w4", torch.empty((out_dim, in_dim // 2),
                                               device=device, dtype=torch.uint8))
        self.register_buffer("w4_scale", torch.empty(
            (groups, out_dim), device=device, dtype=torch.float32))
        self.bias = empty_param((out_dim,), device, dtype) if bias else None

    @classmethod
    @torch.no_grad()
    def from_float(cls, lin: "Linear", fill: bool = True) -> "Q4Linear":
        w = lin.weight
        q = cls(w.shape[1], w.shape[0], lin.bias is not None, w.device,
                w.dtype)
        if fill:
            w4, scale = int4.quantize_weight_int4(w)
            q.w4.copy_(w4)
            q.w4_scale.copy_(scale)
            if lin.bias is not None:
                q.bias.copy_(lin.bias)
        return q

    def forward(self, x: torch.Tensor, backend: str | None = None, **kw):
        """``kw``: ``x_scale``, ``residual``, ``out_dtype`` of
        :func:`tae_tpu_torch.ops.int4.int4_linear`."""
        return int4.int4_linear(x, self.w4, self.w4_scale, self.bias,
                                backend=backend, **kw)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = empty_param((dim,), device, dtype)
        self.bias = empty_param((dim,), device, dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator | None = None) -> None:
        dev = self.weight.device
        self.weight.copy_(tinit.ones(self.weight.shape, device=dev))
        self.bias.copy_(tinit.zeros(self.bias.shape, device=dev))

    def forward(self, x: torch.Tensor, backend: str | None = None
                ) -> torch.Tensor:
        return layer_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                          self.eps, backend=backend)

    @property
    def affine(self) -> tuple[torch.Tensor, torch.Tensor, float]:
        """``(gamma, beta, eps)``, the form the chained LN epilogues take."""
        return self.weight, self.bias, self.eps

    def quantize(self, x2: torch.Tensor, backend: str | None = None):
        """LayerNorm + per-row int8 of rows x2 (M, D): ``(xq, sx)``."""
        return int8.ln_quant(x2, self.weight, self.bias, self.eps, backend)


# ---------------------------------------------------------------------------
# patch embedding (conv as matmul)
# ---------------------------------------------------------------------------

class PatchProj(nn.Module):
    """The patch-embedding projection, its weight shaped like the
    reference's Conv2d ``(E, C, p, p)`` and applied as a matmul with that
    weight viewed ``(E, C·p²)`` against ``extract_patches`` rows. (A
    ``conv2d`` would run through cuDNN, in TF32 for fp32 by default.)"""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = empty_param(
            (embed_dim, in_chans, patch_size, patch_size), device, dtype)
        self.bias = empty_param((embed_dim,), device, dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        # conv viewed as a linear: fan_in = C·p², fan_out = E
        e = self.weight.shape[0]
        w = tinit.xavier_uniform(generator, (e, self.weight[0].numel()))
        self.weight.copy_(w.view(self.weight.shape))
        self.bias.copy_(tinit.zeros(self.bias.shape, device=generator.device))

    def forward(self, patches: torch.Tensor, backend: str | None = None
                ) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], -1).to(patches.dtype)
        return F.linear(patches, w, self.bias.to(patches.dtype))


class PatchEmbed(nn.Module):
    """(B, C, H, W) images, or (B, N, C·p²) rows already in
    ``extract_patches`` layout -> (B, N, E)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = PatchProj(patch_size, in_chans, embed_dim, device, dtype)

    def forward(self, x: torch.Tensor, backend: str | None = None
                ) -> torch.Tensor:
        if x.ndim == 4:
            x = extract_patches(x, self.patch_size)
        return self.proj(x, backend)


# ---------------------------------------------------------------------------
# attention / mlp / block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: AttentionConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.num_heads = cfg.num_heads
        #: run-time choice for a serving int8 block: int8-output attention
        #: on (True), off (False) or by the rule (None); see
        #: :func:`tae_tpu_torch.ops.attention.attention_route`
        self.attn_q8: bool | None = None
        #: run-time choice for a serving int8 block: the qkv product emits
        #: int8 with per-(row, column block) scales and the int8-input
        #: attention reads it (K4 ``q8_out`` + K15), from
        #: QKV_Q8_MIN_TOKENS tokens; off unless asked, as in the JAX package
        self.qkv_q8 = False
        self.qkv = Linear(cfg.dim, cfg.dim * 3, bias=cfg.qkv_bias,
                          device=device, dtype=dtype)
        if cfg.qk_norm:
            dh = cfg.dim // cfg.num_heads
            self.q_norm = LayerNorm(dh, cfg.ln_eps, device, dtype)
            self.k_norm = LayerNorm(dh, cfg.ln_eps, device, dtype)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Linear(cfg.dim, cfg.dim, device=device, dtype=dtype)

    @property
    def qk_norm(self) -> bool:
        return self.q_norm is not None

    def attend(self, qkv: torch.Tensor, backend: str | None = None,
               serving: bool = False, int8_block: bool = False):
        """Packed (B, N, 3C) qkv through the attention entry the shape
        selects. A float route gives ``(y (B, N, C), None)``; an int8-output
        route (a serving int8 block) gives flat rows ``(yq (B*N, C) int8,
        y_scale (B*N, 1))``."""
        route, q8 = attention_route(qkv.shape[1], int8_block, serving,
                                    self.attn_q8)
        y = packed_attention(qkv, self.num_heads, route, serving, backend)
        return y if q8 else (y, None)

    def attend_qk_norm(self, qkv: torch.Tensor, backend: str | None = None
                       ) -> torch.Tensor:
        """The qk_norm attention of packed (B, N, 3C) qkv -> (B, N, C): the
        heads split, LayerNorm over dh of q and of k (on contiguous rows,
        as the LayerNorm kernel reads them), attention on the unpacked
        operands (v read where it lies in qkv), the heads merged. Always the
        exact softmax: the JAX kernel of this branch has no serving form."""
        b, n, c3 = qkv.shape
        r = qkv.reshape(b, n, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q = self.q_norm(r[0].contiguous(), backend)
        k = self.k_norm(r[1].contiguous(), backend)
        y = attention(q, k, r[2], backend=backend)
        return y.transpose(1, 2).reshape(b, n, c3 // 3)

    def forward(self, x: torch.Tensor, backend: str | None = None,
                serving: bool = False) -> torch.Tensor:
        qkv = self.qkv(x, backend)                          # (B, N, 3C)
        if self.qk_norm:
            return self.proj(self.attend_qk_norm(qkv, backend), backend)
        return self.proj(self.attend(qkv, backend, serving)[0], backend)


class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, device=device, dtype=dtype)
        self.fc2 = Linear(hidden_dim, in_dim, device=device, dtype=dtype)
        #: hidden columns per activation scale of the fused MLP kernel
        #: (int8 or int4: the port uses one value for both)
        self.block_h = int8.DEFAULT_BLOCK_H

    def forward(self, x: torch.Tensor, backend: str | None = None
                ) -> torch.Tensor:
        x = self.fc1(x, backend)
        approx = "tanh" if x.dtype == torch.bfloat16 else "none"
        return self.fc2(F.gelu(x, approximate=approx), backend)


class Block(nn.Module):
    """Pre-LN residual block."""

    def __init__(self, cfg: BlockConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, cfg.ln_eps, device, dtype)
        self.attn = Attention(cfg.attn, device, dtype)
        self.norm2 = LayerNorm(cfg.dim, cfg.ln_eps, device, dtype)
        self.mlp = Mlp(cfg.dim, cfg.mlp_hidden, device, dtype)

    def forward(self, x: torch.Tensor, backend: str | None = None,
                serving: bool = False) -> torch.Tensor:
        if self.is_int8:
            return self.forward_int8(x, backend, serving)[0]
        x = x + self.attn(self.norm1(x, backend), backend, serving)
        return x + self.mlp(self.norm2(x, backend), backend)

    @property
    def is_int8(self) -> bool:
        """All four linears are quantized (int8 or int4, mixed leaves
        allowed) and the block has no qk_norm: the block takes the fused
        serving path."""
        return not self.attn.qk_norm and all(
            isinstance(m, (QLinear, Q4Linear)) for m in (
                self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2))

    def takes_qkv_q8(self, n: int, serving: bool) -> bool:
        """Whether the fused forward runs the qkv product with its int8
        output into the int8-input attention (``attn.qkv_q8``, as the JAX
        package's ``use_i8_qkv``): serving, an int8 qkv leaf, no qk_norm, at
        least QKV_Q8_MIN_TOKENS tokens, and a head dim that divides the
        output's scale block (p128's dh 80 does not divide 512)."""
        a = self.attn
        if not (a.qkv_q8 and serving and isinstance(a.qkv, QLinear)
                and not a.qk_norm and n >= QKV_Q8_MIN_TOKENS):
            return False
        c3 = a.qkv.w_q.shape[0]
        return int8.q8_block(c3) % (c3 // 3 // a.num_heads) == 0

    @property
    def chains_ln(self) -> bool:
        """The block's MLP is the int8 kernel, whose epilogue can emit the
        next LayerNorm's int8 output, and whose norm1 input can come chained
        from such an epilogue. An int4 block neither chains nor is chained
        into (the JAX package runs it without ``ln_in`` / ``norm1_next``)."""
        return self.is_int8 and isinstance(self.mlp.fc1, QLinear) \
            and isinstance(self.mlp.fc2, QLinear)

    def forward_int8(self, x: torch.Tensor, backend: str | None = None,
                     serving: bool = False, ln_in=None,
                     norm1_next: LayerNorm | None = None):
        """The fused int8 serving path of one pre-LN block (counterpart of
        ``int8_block_apply``): LN + quantize (``ln_quant``, or the
        ``(xq, sx)`` chained in from the previous layer as ``ln_in``) -> qkv
        matmul with dequantize epilogue -> attention, with ``serving`` an
        entry whose output is already int8 with per-row scales, otherwise
        one in the compute dtype with the exact softmax, followed by a plain
        per-row quantize -> proj matmul with the residual add and norm2 +
        quantize in its epilogue -> the whole MLP and its residual in one
        kernel, with ``norm1_next`` (the next layer's norm1, or the final
        norm) + quantize in its epilogue. Returns ``(x, ln_next)``;
        ``ln_next`` is the chained ``(xq, sx)`` or None.

        Where :meth:`takes_qkv_q8`, the qkv product emits int8 with
        per-(row, column block) scales, the int8-input attention reads it
        and returns bf16, proj quantizes that per row and adds the residual
        (no LN epilogue), and norm2 + quantize run as ``ln_quant``
        (``int8_block_apply``'s ``use_i8_qkv`` branch).

        Each linear dispatches on its own form. An int4 (``Q4Linear``) proj
        has no LN epilogue, so norm2 + quantize run as ``ln_quant``; an int4
        MLP is the fused ``int4_mlp`` and chains nothing (``norm1_next``
        must be None). An MLP with one int8 and one int4 linear, which only
        a width no config registers produces, runs unfused through its
        quantized linears."""
        b, n, c = x.shape
        x2 = x.reshape(b * n, c)
        xq, sx = ln_in if ln_in is not None else self.norm1.quantize(x2, backend)
        a = self.attn
        if self.takes_qkv_q8(n, serving):
            qkv_q, qkv_s = a.qkv(xq, backend, x_scale=sx, q8_out=True)
            y = qkv_i8_attention(qkv_q.reshape(b, n, 3 * c), qkv_s,
                                 a.num_heads, backend)
            x2 = a.proj(y.reshape(b * n, c), backend, residual=x2,
                        out_dtype=x.dtype)
            return self._mlp_half(x, x2, None, None, backend, norm1_next)
        qkv = a.qkv(xq, backend, x_scale=sx, out_dtype=x.dtype)
        y, y_scale = a.attend(qkv.reshape(b, n, 3 * c), backend, serving,
                              int8_block=True)
        xq2 = sx2 = None
        if isinstance(a.proj, QLinear):
            x2, xq2, sx2 = a.proj(y.reshape(b * n, c), backend,
                                  x_scale=y_scale, residual=x2,
                                  out_dtype=x.dtype, ln_out=self.norm2.affine)
        else:
            x2 = a.proj(y.reshape(b * n, c), backend, x_scale=y_scale,
                        residual=x2, out_dtype=x.dtype)
        return self._mlp_half(x, x2, xq2, sx2, backend, norm1_next)

    def _mlp_half(self, x, x2, xq2, sx2, backend, norm1_next):
        """x2 + MLP(norm2(x2)) of :meth:`forward_int8`; ``(xq2, sx2)``: the
        proj epilogue's norm2 + quantize, or None."""
        b, n, c = x.shape
        if not self.chains_ln:
            if norm1_next is not None:
                raise ValueError("only the int8 MLP kernel chains a next "
                                 "LayerNorm")
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            if not (isinstance(fc1, Q4Linear) and isinstance(fc2, Q4Linear)):
                out = x2 + self.mlp(self.norm2(x2, backend), backend)
                return out.reshape(b, n, c), None
            if xq2 is None:
                xq2, sx2 = self.norm2.quantize(x2, backend)
            out = int4.int4_mlp(xq2, sx2, fc1, fc2, x2, self.mlp.block_h,
                                x.dtype, backend)
            return out.reshape(b, n, c), None
        if xq2 is None:
            xq2, sx2 = self.norm2.quantize(x2, backend)
        out = int8.int8_mlp(
            xq2, sx2, self.mlp.fc1, self.mlp.fc2, x2, self.mlp.block_h,
            x.dtype, None if norm1_next is None else norm1_next.affine,
            backend)
        if norm1_next is None:
            return out.reshape(b, n, c), None
        out, nq, ns = out
        return out.reshape(b, n, c), (nq, ns)


def blocks(cfg: BlockConfig, depth: int, device=None,
           dtype=torch.float32) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, device, dtype) for _ in range(depth))


def blocks_apply(stack: nn.ModuleList, x: torch.Tensor,
                 backend: str | None = None, serving: bool = False,
                 final_norm: LayerNorm | None = None,
                 remat: bool | str = False):
    """Apply the blocks in order. Consecutive int8 blocks are chained: each
    MLP epilogue emits the next block's LN'd int8 input. With
    ``final_norm`` (the caller has a quantized head behind that norm) the
    last int8 block chains the final LayerNorm the same way and the result
    is ``(x, ln)``, ``ln`` being the head's ``(xq, sx)`` or None. Int4
    blocks run one by one, unchained (:attr:`Block.chains_ln`).

    ``remat=True`` keeps only each float block's input for the backward
    pass and recomputes the block there (``torch.utils.checkpoint``,
    non-reentrant): one more forward per block, about a block's worth of
    activations in memory instead of every block's. The JAX package's
    string policies (``"dots"``, ``"dots_no_batch"``) name what XLA saves
    and have no counterpart; an int8 block is forward-only and has nothing
    to rematerialize."""
    if isinstance(remat, str):
        raise NotImplementedError(
            f"remat={remat!r} is a jax.checkpoint policy of XLA (which "
            "matmul outputs it keeps); the port has remat=True (recompute "
            "the whole block) or False")
    ln = None
    for i, blk in enumerate(stack):
        if remat and blk.is_int8:
            raise ValueError("remat applies to float blocks; an int8 block "
                             "is forward-only (serving)")
        if not blk.is_int8:
            if remat and torch.is_grad_enabled():
                # a block draws no random numbers: nothing to save or restore
                x = checkpoint(blk, x, backend, serving, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, backend, serving)
            ln = None
            continue
        nxt = stack[i + 1] if i + 1 < len(stack) else None
        if not blk.chains_ln:
            norm1_next = None
        elif nxt is not None:
            norm1_next = nxt.norm1 if nxt.chains_ln else None
        else:
            norm1_next = final_norm
        x, ln = blk.forward_int8(x, backend, serving, ln_in=ln,
                                 norm1_next=norm1_next)
    return (x, ln) if final_norm is not None else x


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every layer of ``module`` in registration order."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_weights_"):
            m.init_weights_(generator)
