"""VQ bottleneck: codebook nearest neighbour and the straight-through
estimator (counterpart of ``tae_tpu/ops/quantizer.py``).

Off by default (``TAEConfig.quantize=False``). The distance argmin is one
matrix product: ``argmin_k |z - c_k|^2 = argmin_k (|c_k|^2 - 2 z.c_k)``. On a
CUDA tensor :func:`nearest_code` launches the hand-written kernel
(:mod:`tae_tpu_torch.ops.cuda.quantizer`), which streams the codebook and
never writes the distances; the plain version runs for CPU tensors and on
an explicit ``backend="reference"``, at every latent width (the kernel
tiles wide latents over V; the JAX dispatch falls to its plain version
above 2048). The estimator and the losses around it are plain
PyTorch, where autograd gives the codebook and commitment gradients; the
argmin itself has none.

Both versions search in z's dtype: the codebook is rounded to it first, then
the distances are fp32 sums of exact products of the rounded operands. With
fp32 parameters and bf16 latents (a train step) kernel and plain version so
compute one function.
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.attention import resolve_backend
from tae_tpu_torch.ops.cuda import quantizer as _q
from tae_tpu_torch.ops.cuda.quantizer import nearest_code_reference


def nearest_code(z: torch.Tensor, codebook: torch.Tensor,
                 backend: str | None = None) -> torch.Tensor:
    """int64 ids of the nearest codebook rows. z (..., V), codebook (K, V)
    -> (...,); the lowest index wins a tie."""
    if resolve_backend(backend, z) == "kernel":
        lead = z.shape[:-1]
        z2 = z.detach().reshape(-1, z.shape[-1]).contiguous()
        return _q.nearest_code(z2, codebook).reshape(lead)
    return nearest_code_reference(z, codebook)


def vq_ste(z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25,
           backend: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize z to its nearest codes with a straight-through gradient.
    Returns ``(z_q, aux)``: ``aux`` = codebook loss + ``beta`` * commitment
    loss (fp32 means); ``z_q`` has the codes' values and passes the gradient
    to z unchanged."""
    idx = nearest_code(z, codebook, backend)
    zq = codebook[idx].to(z.dtype)
    z32, zq32 = z.float(), zq.float()
    codebook_loss = (zq32 - z32.detach()).square().mean()
    commit_loss = (z32 - zq32.detach()).square().mean()
    aux = codebook_loss + beta * commit_loss
    return z + (zq - z).detach(), aux


def encode_indices(z: torch.Tensor, codebook: torch.Tensor,
                   backend: str | None = None) -> torch.Tensor:
    """Discrete token ids of a latent batch (the serving path)."""
    return nearest_code(z, codebook, backend)


def decode_indices(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    return codebook[idx]
