"""LayerNorm with fp32 statistics (counterpart of ``tae_tpu/ops/layernorm.py``).

Statistics and the affine transform run in fp32 and the result is cast back
to the input dtype, as torch autocast runs LayerNorm. The kernels are in
:mod:`tae_tpu_torch.ops.cuda.layernorm` (:func:`fused_layer_norm`, which
carries a gradient through a backward kernel of its own); this module holds
their plain versions and the dispatcher.
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.attention import resolve_backend


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, backend: str | None = None) -> torch.Tensor:
    if resolve_backend(backend, x) == "kernel":
        from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm

        return fused_layer_norm(x, weight, bias, eps)
    return layer_norm_reference(x, weight, bias, eps)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Counterpart of ``layer_norm_xla``: fp32 mean and centred variance,
    fp32 affine, one cast back."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) / torch.sqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_stats_reference(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, eps: float = 1e-6):
    """Plain version of the training forward: ``(y, mean, rstd)`` with the
    fp32 statistics of each row, flat ``(M,)``, as the backward reads them."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    y = xc * rstd * weight.float() + bias.float()
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                                  mean: torch.Tensor, rstd: torch.Tensor,
                                  dy: torch.Tensor):
    """Plain version of the backward kernel, the formula step by step in
    fp32: ``(dx, dw, db)`` from x (..., D), the weight (D,), the saved
    statistics (M,) and the output's gradient dy (..., D).

    dx is rounded once to x's dtype; dw and db are summed over all rows in
    fp32 and rounded once to the **weight's** dtype. The model hands the
    kernel its fp32 LayerNorm parameters cast to the activations' dtype, so
    under bf16 compute dw and db leave here in bf16 and autograd's cast
    brings them back to fp32: the JAX package does the same
    (``cast_to_compute`` over the parameter tree, then
    ``dw_acc[0].astype(weight.dtype)``)."""
    d = x.shape[-1]
    x32, g32 = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    xhat = (x32 - mean[:, None]) * rstd[:, None]
    g = g32 * weight.float()
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (g - m1 - xhat * m2) * rstd[:, None]
    dw = (g32 * xhat).sum(dim=0)
    db = g32.sum(dim=0)
    return (dx.to(x.dtype).reshape(x.shape), dw.to(weight.dtype),
            db.to(weight.dtype))
