"""Activation-range calibration for the quantized serving path (counterpart
of ``tae_tpu/calibrate.py``).

The int8 and int4 serving modes quantize activations per row, so a few
large channels set every other channel's step size.
:func:`tae_tpu_torch.ops.int8.equalize_params_` flattens that spread by
folding per-channel factors into the LayerNorm affines; without data it
estimates each channel's range from the affine itself. :func:`ln_amax`
measures it instead: the per-channel amax of every LayerNorm output that
feeds a quantized linear, over real batches (the SmoothQuant calibration
pass, arXiv:2211.10438 §4), keyed by the module name of that linear::

    stats = calibrate.ln_amax(model, batches)     # the float model
    tok = Tokenizer.from_checkpoint(name, ckpt, quantization="int8",
                                    equalize=0.5, act_amax=stats)

or in one step with ``Tokenizer.from_checkpoint(..., equalize=0.5,
calib_images=batches)``. Statistics measured by the JAX package cross with
:func:`tae_tpu_torch.ckpt.bridge.act_amax_from_jax`.

The port's layers are modules, so forward hooks on the LayerNorms capture
the activations the JAX package's layer loop computes. As there, the pass
runs the model's parameters as they are (bf16 in a bf16 tokenizer) on fp32
activations, with the exact softmax: every layer casts its parameters to the
activations' dtype, which for bf16 values is exact, so the pass computes in
fp32 on the bf16-rounded weights, as the JAX package's mixed-dtype products
do. On the card its LayerNorms and attention run the fp32 forms of K1 and
K2.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from tae_tpu_torch.utils.dtypes import FP32


def taps(model: nn.Module) -> list[tuple[nn.Module, str]]:
    """(LayerNorm, name of the quantized linear it feeds) for every such
    pair of a float TAE: ``norm1`` -> ``attn.qkv`` and ``norm2`` ->
    ``mlp.fc1`` in every block, ``norm`` -> ``dict_proj`` and
    ``decoder_norm`` -> ``decoder_pred``; a pruned half has none."""
    from tae_tpu_torch.nn import vit

    out = []
    for name, blk in model.named_modules():
        if isinstance(blk, vit.Block):
            out += [(blk.norm1, f"{name}.attn.qkv"),
                    (blk.norm2, f"{name}.mlp.fc1")]
    for norm, head in (("norm", "dict_proj"), ("decoder_norm", "decoder_pred")):
        if hasattr(model, norm) and hasattr(model, head):
            out.append((getattr(model, norm), head))
    return out


def _forward(model: nn.Module, batch, backend: str | None) -> None:
    """One batch through whatever halves ``model`` holds, as the JAX
    package's ``_batch_stats`` runs it: uint8 batches normalized first, (B,
    C, H, W) images or pre-patchified (B, N, C·p²) rows into the encoder,
    latents into a decoder-only model, and with the VQ bottleneck the
    decoder fed the codebook vectors."""
    from tae_tpu_torch.data.transforms import maybe_device_normalize

    c = model.cfg
    device = next(model.parameters()).device
    x = torch.as_tensor(batch).to(device)
    if model.has_encoder:
        x = maybe_device_normalize(x, c.patch_size, torch.float32)
        z = model.forward_encoder(x, policy=FP32, backend=backend)
    else:
        z = x.float()               # a decoder-only model: latents
    if c.quantize and hasattr(model, "codebook"):
        from tae_tpu_torch.ops.quantizer import vq_ste

        z, _ = vq_ste(z, model.codebook, c.commitment_beta, backend)
    if model.has_decoder:
        model.forward_decoder(z, policy=FP32, backend=backend)


@torch.no_grad()
def ln_amax(model: nn.Module, batches: Iterable, margin: float = 1.0,
            backend: str | None = None) -> dict[str, torch.Tensor]:
    """Per-channel fp32 amax of each LayerNorm output that feeds a
    quantized linear, ``{linear name: (D,) tensor}``, for
    ``equalize_params_(act_amax=...)``.

    ``model``: the float model (before quantization; a pruned one has stats
    for the half it holds). ``batches``: an iterable of image batches (B,
    3, H, W), float or uint8, or pre-patchified (B, N, C·p²) rows, or
    latents for a decoder-only model. The amax is taken over all leading
    axes and max-accumulated across batches, then scaled by ``margin`` (>1
    guards against outliers the batches did not show). ``backend``: as
    everywhere, None runs the kernels on CUDA tensors."""
    acc: dict[str, torch.Tensor] = {}

    def hook(key):
        def record(module, args, out):
            a = out.float().abs().amax(dim=tuple(range(out.ndim - 1)))
            acc[key] = a if key not in acc else torch.maximum(acc[key], a)
        return record

    handles = [norm.register_forward_hook(hook(key))
               for norm, key in taps(model)]
    try:
        seen = False
        for batch in batches:
            _forward(model, batch, backend)
            seen = True
    finally:
        for h in handles:
            h.remove()
    if not seen:
        raise ValueError("ln_amax needs at least one calibration batch")
    if margin != 1.0:
        acc = {k: v * margin for k, v in acc.items()}
    return acc
