"""High-level tokenizer API, the serving face of the port (counterpart of
``tae_tpu/tokenizer.py``)::

    tok = Tokenizer.from_checkpoint("tae_patch16_vocab256_px256", ckpt_path)
    z   = tok.encode(images)        # (B, N, vocab) bf16 latents
    rec = tok.decode(z)             # (B, 3, H, W) reconstructions

Inputs are normalized (B, C, H, W) float batches or raw uint8 pixel batches
(normalized on the device). Parameters are held in the compute dtype
(bf16 by default), so serving never re-casts per call. On CUDA every
LayerNorm and attention runs through the hand-written kernels; ``backend=
"reference"`` runs the plain PyTorch versions instead, for comparisons.

``quantization="int8"`` serves through the fused w8a8 block (int8 weights
with per-channel scales, dynamic per-row activation scales; see
:mod:`tae_tpu_torch.ops.int8`)::

    tok = Tokenizer.from_checkpoint(name, ckpt, quantization="int8")
    tok.save_serving("tok.int8.pt")           # quantize once, ship the file
    tok = Tokenizer.from_serving(name, "tok.int8.pt")

In int8 serving the attention kernel itself emits the proj matmul's int8
input (:func:`tae_tpu_torch.ops.attention.attention_route`); ``attn_q8=False``
asks for the attention output in the compute dtype and a plain per-row
quantize instead, ``attn_q8=True`` forces the int8 output.
"""

from __future__ import annotations

import dataclasses

import torch

from tae_tpu_torch.utils.dtypes import Policy

_NOT_YET = {
    "int4": "int4 (w4a8) serving is not ported yet (ROADMAP A10)",
    "calibrate": "measured activation statistics (act_amax / calib_images) "
                 "are not ported yet (ROADMAP A8: calibrate.py)",
    "discrete": "the VQ bottleneck is not ported yet (ROADMAP A11)",
}


def set_attn_q8(model, attn_q8: bool | None) -> None:
    """Record the run-time int8-output choice on every attention layer."""
    from tae_tpu_torch.nn import vit

    for mod in model.modules():
        if isinstance(mod, vit.Attention):
            mod.attn_q8 = attn_q8


def prune_component(model, component: str):
    """Drop the unused half of a TAE in place: ``"encoder"`` removes the
    decoder's layers (encode-only serving halves resident weights),
    ``"decoder"`` the encoder's, ``"both"`` keeps everything."""
    from tae_tpu_torch.models.tae import DECODER_PARTS, ENCODER_PARTS

    if component == "both":
        return model
    if component not in ("encoder", "decoder"):
        raise ValueError(f"unknown component {component!r}")
    for name in DECODER_PARTS if component == "encoder" else ENCODER_PARTS:
        delattr(model, name)
    return model


@dataclasses.dataclass
class Tokenizer:
    model: torch.nn.Module           # tae_tpu_torch.models.tae.TAE
    policy: Policy
    backend: str | None = None       # None: kernels on CUDA, plain on CPU

    @classmethod
    def from_checkpoint(cls, model_name: str, ckpt: str | None = None,
                        dtype: torch.dtype = torch.bfloat16,
                        device: torch.device | str = "cuda",
                        quantization: str | None = None,
                        component: str = "both",
                        equalize: float | bool | None = None,
                        act_amax=None, calib_images=None,
                        patch_input: bool = False,
                        seed: int = 0,
                        attn_q8: bool | None = None,
                        **model_overrides) -> "Tokenizer":
        """Build ``model_name`` on ``device``, initialise it from
        ``torch.Generator(device).manual_seed(seed)``, load ``ckpt`` (a
        reference-layout ``.pth``) if given, and cast it to ``dtype``.
        ``component`` prunes the unused half.

        ``quantization="int8"`` rewrites the linear weights to int8 with
        per-channel scales (the w8a8 serving path). ``equalize``:
        SmoothQuant-style equalization before quantizing (``True`` -> alpha
        0.5, or the alpha), an exact float rewrite that folds per-channel
        factors into the LN affines. ``patch_input=True`` declares that
        encode requests are pre-patchified (B, N, C*p*p) rows; int8 then
        quantizes the patch embedding too (image requests still work).
        ``attn_q8``: whether an int8 block's attention emits int8 directly
        (None: the rule of ``attention_route``); a run-time choice that the
        serving artifact does not record."""
        from tae_tpu_torch import models
        from tae_tpu_torch.ckpt.bridge import load_pth
        from tae_tpu_torch.ops.int8 import prepare_serving_

        if quantization == "int4":
            raise NotImplementedError(_NOT_YET["int4"])
        if act_amax is not None or calib_images is not None:
            raise NotImplementedError(_NOT_YET["calibrate"])
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization mode {quantization!r}")
        if equalize and quantization is None:
            raise ValueError("equalize= only applies to the quantized "
                             "serving modes (it rewrites ranges the bf16 "
                             "path never quantizes)")
        device = torch.device(device)
        model = models.create(model_name, device=device, **model_overrides)
        model.init_weights_(torch.Generator(device=device).manual_seed(seed))
        if ckpt:
            model.load_state_dict(load_pth(ckpt), strict=True)
        # prune before quantizing, so the dropped half is never quantized
        model = prune_component(model.to(dtype).eval(), component)
        if quantization is not None:
            prepare_serving_(model, quantization, equalize or 0.0,
                             patch_input=patch_input)
        set_attn_q8(model, attn_q8)
        return cls(model=model,
                   policy=Policy(param_dtype=dtype, compute_dtype=dtype))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------- serving artifact
    def save_serving(self, path) -> None:
        """Persist the serving parameters (int8 if quantized) so a
        deployment skips checkpoint load and quantization at start-up:
        a ``torch.save`` of the state dict plus what is needed to rebuild
        its layout."""
        from tae_tpu_torch.nn import vit

        m = self.model
        quantized = sorted(name for name, mod in m.named_modules()
                           if isinstance(mod, vit.QLinear))
        block_h = {mod.block_h for mod in m.modules()
                   if isinstance(mod, vit.Mlp)}
        if len(block_h) > 1:
            raise ValueError(f"MLPs disagree on block_h: {sorted(block_h)}")
        sd = {k: v.detach().cpu() for k, v in m.state_dict().items()}
        torch.save({"model": sd, "serving": True,
                    "compute_dtype": str(self.policy.compute_dtype),
                    "component": ("both" if m.has_encoder and m.has_decoder
                                  else "encoder" if m.has_encoder
                                  else "decoder"),
                    "quantized": quantized,
                    "mlp_block_h": block_h.pop() if block_h else None},
                   path)

    @classmethod
    def from_serving(cls, model_name: str, path,
                     dtype: torch.dtype | None = None,
                     device: torch.device | str = "cuda",
                     component: str = "both",
                     attn_q8: bool | None = None,
                     **model_overrides) -> "Tokenizer":
        """Load a :meth:`save_serving` artifact (no re-quantization).
        ``dtype=None`` restores the compute dtype the artifact recorded.
        ``component`` prunes further; a half the artifact does not hold
        cannot be asked for."""
        from tae_tpu_torch import models
        from tae_tpu_torch.nn import vit

        blob = torch.load(path, map_location="cpu", weights_only=True)
        if not (isinstance(blob, dict) and blob.get("serving")):
            raise ValueError(f"{str(path)!r} is not a serving artifact "
                             "(use from_checkpoint for training checkpoints)")
        if dtype is None:
            dtype = getattr(torch, blob["compute_dtype"].split(".")[-1])
        saved = blob["component"]
        if saved != "both" and component not in (saved, "both"):
            raise ValueError(f"the artifact holds only the {saved}")
        device = torch.device(device)
        model = models.create(model_name, device=device, **model_overrides)
        model = prune_component(model.to(dtype).eval(), saved)
        for name in blob["quantized"]:
            parent, _, leaf = name.rpartition(".")
            owner = model.get_submodule(parent) if parent else model
            setattr(owner, leaf, vit.QLinear.from_float(getattr(owner, leaf),
                                                        fill=False))
        for mod in model.modules():
            if isinstance(mod, vit.Mlp) and blob["mlp_block_h"]:
                mod.block_h = blob["mlp_block_h"]
        model.load_state_dict(blob["model"], strict=True)
        if saved == "both":
            model = prune_component(model, component)
        set_attn_q8(model, attn_q8)
        return cls(model=model,
                   policy=Policy(param_dtype=dtype, compute_dtype=dtype))

    # ------------------------------------------------------------------ api
    @torch.inference_mode()
    def encode(self, images) -> torch.Tensor:
        """(B, 3, H, W) -> (B, N, vocab) latents. Accepts normalized float
        batches or raw uint8 pixel batches (normalized on the device), and
        pre-patchified (B, N, C·p²) rows of either."""
        from tae_tpu_torch.data.transforms import maybe_device_normalize

        if not self.model.has_encoder:
            raise ValueError("encoder was pruned (component='decoder')")
        m, pol = self.model, self.policy
        x = torch.as_tensor(images).to(self.device)
        x = maybe_device_normalize(x, m.cfg.patch_size, pol.compute_dtype)
        # serving=True: a pure-inference surface, so the clamped softmax is
        # safe here; parity and training paths keep the exact form
        return m.forward_encoder(x, policy=pol, backend=self.backend,
                                 serving=True)

    @torch.inference_mode()
    def decode(self, latents) -> torch.Tensor:
        """(B, N, vocab) latents -> (B, 3, H, W) reconstructions."""
        if not self.model.has_decoder:
            raise ValueError("decoder was pruned (component='encoder')")
        m = self.model
        z = torch.as_tensor(latents).to(self.device)
        return m.unpatchify(m.forward_decoder(z, policy=self.policy,
                                              backend=self.backend,
                                              serving=True))

    def reconstruct(self, images) -> torch.Tensor:
        return self.decode(self.encode(images))

    def encode_discrete(self, images_or_latents) -> torch.Tensor:
        raise NotImplementedError(_NOT_YET["discrete"])

    def decode_discrete(self, ids) -> torch.Tensor:
        raise NotImplementedError(_NOT_YET["discrete"])
