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
    holds :class:`QLinear` layers; a block whose linears are all quantized
    takes the fused int8 forward (:meth:`Block.forward_int8`), any other
    block the float forward.

The JAX package's ``unroll``, ``scan`` and ``remat`` have no meaning for an
eager forward and are dropped. ``qk_norm`` and the int4 layout are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tae_tpu_torch.nn import init as tinit
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.attention import attention_route, packed_attention
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
        if cfg.qk_norm:
            raise NotImplementedError(
                "qk_norm attention is not ported yet (ROADMAP B16: its "
                "unpacked flash_attention kernel)")
        self.num_heads = cfg.num_heads
        #: run-time choice for a serving int8 block: int8-output attention
        #: on (True), off (False) or by the rule (None); see
        #: :func:`tae_tpu_torch.ops.attention.attention_route`
        self.attn_q8: bool | None = None
        self.qkv = Linear(cfg.dim, cfg.dim * 3, bias=cfg.qkv_bias,
                          device=device, dtype=dtype)
        self.proj = Linear(cfg.dim, cfg.dim, device=device, dtype=dtype)

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

    def forward(self, x: torch.Tensor, backend: str | None = None,
                serving: bool = False) -> torch.Tensor:
        qkv = self.qkv(x, backend)                          # (B, N, 3C)
        return self.proj(self.attend(qkv, backend, serving)[0], backend)


class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, device=device, dtype=dtype)
        self.fc2 = Linear(hidden_dim, in_dim, device=device, dtype=dtype)
        #: hidden columns per activation scale of the fused int8 MLP
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
        """All four linears are quantized: the block takes the fused path."""
        return all(isinstance(m, QLinear) for m in (
            self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2))

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
        ``ln_next`` is the chained ``(xq, sx)`` or None."""
        b, n, c = x.shape
        x2 = x.reshape(b * n, c)
        xq, sx = ln_in if ln_in is not None else self.norm1.quantize(x2, backend)
        a = self.attn
        qkv = a.qkv(xq, backend, x_scale=sx, out_dtype=x.dtype)
        y, y_scale = a.attend(qkv.reshape(b, n, 3 * c), backend, serving,
                              int8_block=True)
        x2, xq2, sx2 = a.proj(y.reshape(b * n, c), backend, x_scale=y_scale,
                              residual=x2, out_dtype=x.dtype,
                              ln_out=self.norm2.affine)
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
                 final_norm: LayerNorm | None = None):
    """Apply the blocks in order. Consecutive int8 blocks are chained: each
    MLP epilogue emits the next block's LN'd int8 input. With
    ``final_norm`` (the caller has a quantized head behind that norm) the
    last int8 block chains the final LayerNorm the same way and the result
    is ``(x, ln)``, ``ln`` being the head's ``(xq, sx)`` or None."""
    ln = None
    for i, blk in enumerate(stack):
        if not blk.is_int8:
            x, ln = blk(x, backend, serving), None
            continue
        nxt = stack[i + 1] if i + 1 < len(stack) else None
        if nxt is not None:
            norm1_next = nxt.norm1 if nxt.is_int8 else None
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
