"""Attention reference and backend resolution (counterpart of
``tae_tpu/ops/attention.py``).

Backends:
  * ``"kernel"``: the hand-written CUDA kernels in :mod:`tae_tpu_torch.ops.cuda`;
  * ``"reference"``: the plain PyTorch versions.

``default_backend`` resolves from the tensor's device alone: CUDA tensors
take the kernels, CPU tensors the plain versions. The plain versions run on
a CUDA tensor only when a caller passes ``backend="reference"`` itself.

:func:`attention_route` picks which packed-qkv attention entry a block runs
from the shape alone; :func:`packed_attention` runs it. The rule is the
H100's own (measured by ``chip_smoke.py``, recorded in ``PERF.md``); the JAX
package's thresholds and environment switches have no counterpart.

:func:`attention` is the unpacked (B, H, N, dh) entry of a qk_norm block;
:func:`qkv_i8_attention` the int8-input entry of an int8 block with
``qkv_q8`` on (:data:`QKV_Q8_MIN_TOKENS` and up).
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import flash_attention as _fa
from tae_tpu_torch.ops.cuda import wide_attention as _wa

BACKENDS = ("kernel", "reference")

#: route -> (kernel wrapper, plain version)
ROUTES = {
    "packed": (_fa.fused_qkv_attention, _fa.fused_qkv_attention_reference),
    "wide": (_wa.fused_qkv_attention_wide,
             _wa.fused_qkv_attention_wide_reference),
    "packed_q8": (_wa.fused_qkv_attention_q8,
                  _wa.fused_qkv_attention_q8_reference),
    "wide_q8": (_wa.fused_qkv_attention_wide_q8,
                _wa.fused_qkv_attention_wide_q8_reference),
    "wide_q8_2d": (_wa.fused_qkv_attention_wide_q8_2d,
                   _wa.fused_qkv_attention_wide_q8_2d_reference),
}
#: Most tokens per image at which a float-output block takes the wide entry.
#: Below 16 tokens several images share one 16-row tile, which the per-image
#: kernel pads; from 16 on that kernel stages a head's K and V once for all
#: its query tiles and is the faster one (H100, B = 64: 0.0100 against
#: 0.0106 ms at 16 tokens, 0.0533 against 0.0816 ms at 64; level at 4 and 8).
FLOAT_WIDE_MAX_TOKENS = 8
#: Most tokens per image at which an int8-output block takes the wide entry
#: (the limit of those entries; above it the per-image int8-output entry).
Q8_WIDE_MAX_TOKENS = _wa.WIDE_MAX_TOKENS
#: below this many tokens the int8 block calls the flat-row (2D) entry
FLAT_BELOW_TOKENS = 8
#: Fewest tokens per image at which an int8 block with ``qkv_q8`` on feeds
#: the qkv product's int8 output to the int8-input attention (K15): the JAX
#: package's gate (its per-image kernels' crossover), kept as it is. Below,
#: such a block takes the default int8 route.
QKV_Q8_MIN_TOKENS = 128


def default_backend(x: torch.Tensor) -> str:
    return "kernel" if x.is_cuda else "reference"


def resolve_backend(backend: str | None, x: torch.Tensor) -> str:
    resolved = backend or default_backend(x)
    if resolved not in BACKENDS:
        raise ValueError(f"unknown backend {resolved!r}; expected one of "
                         f"{BACKENDS}")
    return resolved


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """q, k, v: (B, H, N, dh) -> (B, H, N, dh); counterpart of
    ``attention_xla``. Scores and softmax in fp32 (the operands are upcast,
    so bf16 products are exact and the sums fp32), probabilities cast to
    v's dtype before the P·V product."""
    dh = q.shape[-1]
    if scale is None:
        scale = dh ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None = None,
              backend: str | None = None) -> torch.Tensor:
    """q, k, v (B, H, N, dh) -> (B, H, N, dh), the exact softmax
    (counterpart of ``tae_tpu.ops.attention.attention``). The kernel K16 (and
    K17 for its gradient, :class:`~tae_tpu_torch.ops.cuda.flash_attention.
    FlashAttentionFn`) at every token count: the JAX package runs XLA below
    128 tokens, but on the H100 one K16 launch beats the plain version's
    matmul / softmax / matmul chain at 4 and 16 tokens as at 256 (PERF.md).
    ``backend="reference"``: :func:`attention_reference`."""
    if resolve_backend(backend, q) == "reference":
        return attention_reference(q, k, v, scale)
    return _fa.flash_attention(q, k, v, scale)


def qkv_i8_attention(qkv_q: torch.Tensor, scales: torch.Tensor,
                     num_heads: int, backend: str | None = None
                     ) -> torch.Tensor:
    """int8 packed qkv (B, N, 3C) with its ``q8_out`` scales -> (B, N, C)
    bfloat16, the serving softmax (K15, or its plain version)."""
    fn = (_fa.fused_qkv_attention_i8_reference
          if resolve_backend(backend, qkv_q) == "reference"
          else _fa.fused_qkv_attention_i8)
    return fn(qkv_q, scales, num_heads)


def attention_route(n: int, int8_block: bool, serving: bool,
                    attn_q8: bool | None = None) -> tuple[str, bool]:
    """Which packed-qkv attention entry runs for ``n`` tokens per image, and
    whether its output is int8: ``(route, int8_out)``, route a key of
    :data:`ROUTES`.

    A float block, and an int8 block outside serving (the int8-output
    entries have the clamped softmax only), take the wide entry up to 8
    tokens and the per-image entry above. A serving int8 block takes an
    int8-output entry at every n: the flat-row one below 8 tokens, the wide
    one up to 64, the per-image one above; its ``(y, y_scale)`` is the proj
    matmul's prequantized input, and no separate quantize pass runs. The
    JAX package takes the int8 output up to 64 tokens only; on the H100 it
    wins above too (NVIDIA H100 80GB HBM3 at 700 W, B = 64, ``chip_smoke.py``:
    K7 0.1429 ms at 256 tokens against 0.4096 for the per-image kernel plus
    the plain per-row quantize, the p16 int8 request 21.92 against 25.97
    ms; K8 0.0454 against 0.1878 ms at 64 tokens, the p32 request 21.82
    against 24.83 ms; K9 0.0075 against 0.0361 ms at 4 tokens and 256
    rows, 0.0065 against 0.0249 at 4 rows).
    ``attn_q8`` forces the int8 output on (True) or off (False) for a
    serving int8 block; None is the rule."""
    q8 = int8_block and serving and (attn_q8 is None or bool(attn_q8))
    if not q8:
        return ("wide" if n <= FLOAT_WIDE_MAX_TOKENS else "packed"), False
    if n < FLAT_BELOW_TOKENS:
        return "wide_q8_2d", True
    return ("wide_q8" if n <= Q8_WIDE_MAX_TOKENS else "packed_q8"), True


def packed_attention(qkv: torch.Tensor, num_heads: int, route: str,
                     serving: bool = False, backend: str | None = None):
    """Run ``route`` on packed qkv (B, N, 3C). Float routes return y
    (B, N, C); int8-output routes return flat rows ``(yq (B*N, C) int8,
    y_scale (B*N, 1) fp32)``, the form the proj matmul reads.

    Where autograd records through qkv, the float routes carry the gradient
    with ``serving=False`` (``"packed"``: forward and backward kernels;
    ``"wide"``: forward kernel, backward through the plain reference;
    ``backend="reference"``: plain autograd). The kernels' serving forms and
    the int8-output routes are forward-only and raise."""
    kernel, plain = ROUTES[route]
    fn = plain if resolve_backend(backend, qkv) == "reference" else kernel
    b, n, c3 = qkv.shape
    if route in ("packed", "wide"):
        return fn(qkv, num_heads, serving=serving)
    if not serving:
        raise ValueError(f"route {route!r} has the serving softmax only")
    _wa.build.refuse_grad(f"packed_attention(route={route!r})", qkv)
    if route == "wide_q8_2d":
        return fn(qkv.reshape(b * n, c3), n, num_heads)
    yq, ys = fn(qkv, num_heads)
    return yq.reshape(b * n, c3 // 3), ys.reshape(b * n, 1)
