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
quantize instead, ``attn_q8=True`` forces the int8 output. ``qkv_q8=True``
turns on the other direction, off by default as in the JAX package
(``TAE_TPU_QKV_Q8``): from 128 tokens the qkv product emits int8 with one
scale per row and 512-column block, and the int8-input attention reads it.

``quantization="int4"`` stores the four linears of every block as packed
int4 with group-wise scales (w4a8; half the weight bytes of int8, for
small-batch serving of the widest configs, where a request streams every
weight once; a coarser code, see :mod:`tae_tpu_torch.ops.int4`); the heads
stay int8 and the patch embedding float.

A model built with ``quantize=True`` has the VQ bottleneck's codebook::

    tok = Tokenizer.from_checkpoint(name, ckpt, quantize=True)
    ids = tok.encode_discrete(images)          # (B, N) int64 token ids
    rec = tok.decode_discrete(ids)             # (B, 3, H, W)
"""

from __future__ import annotations

import dataclasses

import torch

from tae_tpu_torch.utils.dtypes import Policy


def set_attn_q8(model, attn_q8: bool | None) -> None:
    """Record the run-time int8-output choice on every attention layer."""
    from tae_tpu_torch.nn import vit

    for mod in model.modules():
        if isinstance(mod, vit.Attention):
            mod.attn_q8 = attn_q8


def set_qkv_q8(model, qkv_q8: bool) -> None:
    """Record the run-time int8-input attention choice on every attention
    layer (see :meth:`tae_tpu_torch.nn.vit.Block.takes_qkv_q8`)."""
    from tae_tpu_torch.nn import vit

    for mod in model.modules():
        if isinstance(mod, vit.Attention):
            mod.qkv_q8 = bool(qkv_q8)


def prune_component(model, component: str):
    """Drop the unused half of a TAE in place: ``"encoder"`` removes the
    decoder's layers (encode-only serving halves resident weights),
    ``"decoder"`` the encoder's, ``"both"`` keeps everything. The VQ
    codebook, which both halves share, always stays."""
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
                        qkv_q8: bool = False,
                        **model_overrides) -> "Tokenizer":
        """Build ``model_name`` on ``device``, initialise it from
        ``torch.Generator(device).manual_seed(seed)``, load ``ckpt`` (a
        reference-layout ``.pth`` or a port checkpoint) if given, and cast
        it to ``dtype``. The load is the JAX package's: positional
        embeddings on another token grid (an ``img_size=`` override) are
        interpolated, keys the file lacks (a codebook asked for with
        ``quantize=True``) keep their initial values, and keys the model
        lacks are dropped (:func:`tae_tpu_torch.ckpt.io.load_params`).
        ``component`` prunes the unused half.

        ``quantization="int8"`` rewrites the linear weights to int8 with
        per-channel scales (the w8a8 serving path), ``"int4"`` the blocks'
        linears to packed int4 with group scales (w4a8). ``equalize``:
        SmoothQuant-style equalization before quantizing (``True`` -> alpha
        0.5, or the alpha), an exact float rewrite that folds per-channel
        factors into the LN affines. By default it estimates each channel's
        activation range from the LN affine; ``act_amax`` passes measured
        ranges (:func:`tae_tpu_torch.calibrate.ln_amax`'s output), and
        ``calib_images``, an iterable of image batches, measures them here
        on the float model (after pruning, before quantizing).
        ``patch_input=True`` declares that
        encode requests are pre-patchified (B, N, C*p*p) rows; int8 then
        quantizes the patch embedding too (image requests still work; int4
        keeps it float either way).
        ``attn_q8``: whether an int8 block's attention emits int8 directly
        (None: the rule of ``attention_route``); ``qkv_q8``: whether an int8
        block from 128 tokens feeds the qkv product's int8 output to the
        int8-input attention; run-time choices that the serving artifact
        does not record."""
        from tae_tpu_torch import models
        from tae_tpu_torch.ckpt.io import load_params
        from tae_tpu_torch.ops.int8 import QUANTIZATIONS, prepare_serving_

        # the JAX package's checks, in its order
        if (act_amax is not None or calib_images is not None) and not equalize:
            raise ValueError("act_amax/calib_images require equalize= "
                             "(they feed the equalization rewrite)")
        if equalize and quantization not in QUANTIZATIONS:
            raise ValueError("equalize= only applies to the quantized "
                             "serving modes (it rewrites ranges the bf16 "
                             "path never quantizes)")
        if quantization is not None and quantization not in QUANTIZATIONS:
            raise ValueError(f"unknown quantization mode {quantization!r}")
        device = torch.device(device)
        model = models.create(model_name, device=device, **model_overrides)
        model.init_weights_(torch.Generator(device=device).manual_seed(seed))
        if ckpt:
            load_params(ckpt, model)
        # prune before quantizing, so the dropped half is never quantized
        model = prune_component(model.to(dtype).eval(), component)
        model.requires_grad_(False)     # a serving surface: nothing trains
        if quantization is not None:
            if equalize and calib_images is not None and act_amax is None:
                from tae_tpu_torch.calibrate import ln_amax

                act_amax = ln_amax(model, calib_images)
            prepare_serving_(model, quantization, equalize or 0.0, act_amax,
                             patch_input=patch_input)
        set_attn_q8(model, attn_q8)
        set_qkv_q8(model, qkv_q8)
        return cls(model=model,
                   policy=Policy(param_dtype=dtype, compute_dtype=dtype))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------- serving artifact
    def save_serving(self, path) -> None:
        """Persist the serving parameters (int8 / int4 if quantized) so a
        deployment skips checkpoint load and quantization at start-up:
        a ``torch.save`` of the state dict plus what is needed to rebuild
        its layout: which linears are int8 and which int4, the int4 byte
        layout's name, and the hidden block of the fused MLP kernels. (An
        int4 leaf's scale group is not recorded: it follows from the shapes
        of ``w4`` and ``w4_scale``, which ``load_state_dict`` holds to this
        build's rule.)"""
        from tae_tpu_torch.nn import vit
        from tae_tpu_torch.ops import int4

        m = self.model
        quantized = sorted(name for name, mod in m.named_modules()
                           if isinstance(mod, vit.QLinear))
        packed = sorted(name for name, mod in m.named_modules()
                        if isinstance(mod, vit.Q4Linear))
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
                    "int4": packed,
                    "int4_layout": int4.LAYOUT if packed else None,
                    "mlp_block_h": block_h.pop() if block_h else None},
                   path)

    @classmethod
    def from_serving(cls, model_name: str, path,
                     dtype: torch.dtype | None = None,
                     device: torch.device | str = "cuda",
                     component: str = "both",
                     attn_q8: bool | None = None,
                     qkv_q8: bool = False,
                     **model_overrides) -> "Tokenizer":
        """Load a :meth:`save_serving` artifact (no re-quantization).
        ``dtype=None`` restores the compute dtype the artifact recorded.
        ``component`` prunes further; a half the artifact does not hold
        cannot be asked for. An artifact without the int4 fields (written
        before the int4 mode existed) holds no int4 linear."""
        from tae_tpu_torch import models
        from tae_tpu_torch.nn import vit
        from tae_tpu_torch.ops import int4

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
        model.requires_grad_(False)
        packed = blob.get("int4") or []
        if packed and blob.get("int4_layout") != int4.LAYOUT:
            raise ValueError(
                f"the artifact's int4 weights are packed as "
                f"{blob.get('int4_layout')!r}; this build reads "
                f"{int4.LAYOUT!r}")
        for names, form in ((blob["quantized"], vit.QLinear),
                            (packed, vit.Q4Linear)):
            for name in names:
                parent, _, leaf = name.rpartition(".")
                owner = model.get_submodule(parent) if parent else model
                setattr(owner, leaf, form.from_float(getattr(owner, leaf),
                                                     fill=False))
        for mod in model.modules():
            if isinstance(mod, vit.Mlp) and blob["mlp_block_h"]:
                mod.block_h = blob["mlp_block_h"]
        model.load_state_dict(blob["model"], strict=True)
        if saved == "both":
            model = prune_component(model, component)
        set_attn_q8(model, attn_q8)
        set_qkv_q8(model, qkv_q8)
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

    def _codebook(self) -> torch.Tensor:
        codebook = getattr(self.model, "codebook", None)
        if codebook is None:
            raise ValueError("model has no codebook; build with quantize=True")
        return codebook

    @torch.inference_mode()
    def encode_discrete(self, images_or_latents) -> torch.Tensor:
        """Nearest-codebook token ids (B, N) int64 of an image batch
        (B, 3, H, W), or of latents (B, N, vocab) already encoded. Needs a
        model built with ``quantize=True``."""
        from tae_tpu_torch.ops.quantizer import encode_indices

        codebook = self._codebook()
        x = torch.as_tensor(images_or_latents)
        z = self.encode(x) if x.ndim == 4 else x.to(self.device)
        return encode_indices(z, codebook, self.backend)

    def decode_discrete(self, ids) -> torch.Tensor:
        """Token ids (B, N) -> (B, 3, H, W): the codebook rows, decoded."""
        from tae_tpu_torch.ops.quantizer import decode_indices

        ids = torch.as_tensor(ids).to(self.device)
        return self.decode(decode_indices(ids, self._codebook()))

    def encode_jpeg(self, jpegs, deterministic: bool = True) -> torch.Tensor:
        """Raw JPEG bytes -> latents through the val transform (resize the
        shorter side to size + 32, centre crop): the native decoder where it
        is built, else PIL. (``deterministic`` is the JAX signature's; the
        val transform is deterministic either way.)"""
        import io

        import numpy as np

        from tae_tpu_torch.data import native
        from tae_tpu_torch.data.transforms import center_crop_transform

        size = self.model.cfg.img_size
        if native.available():
            arrs = [native.center_crop(b, size) for b in jpegs]
        else:
            from PIL import Image

            tf = center_crop_transform(size)
            arrs = [tf(Image.open(io.BytesIO(b)).convert("RGB")) for b in jpegs]
        return self.encode(np.stack(arrs))
