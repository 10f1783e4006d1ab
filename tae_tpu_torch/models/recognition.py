"""Latent-space recognition ViT (counterpart of
``tae_tpu/models/recognition.py``).

Reads frozen TAE encoder latents (B, N, vocab), embeds them, adds a
positional embedding, runs a ViT-Base trunk and its final LayerNorm,
mean-pools over the tokens and applies a linear head (the reference
classifier, reference tae.py:274-338). ``num_classes=None`` builds no head:
the model is then a feature extractor returning the pooled (B, D) features.

Submodule names follow the reference's ``state_dict`` keys
(``decoder_embed``, ``decoder_pos_embed``, ``decoder_blocks.{i}.*``,
``decoder_norm``, ``head``), the keys ``tae_tpu/ckpt/torch_import.py``
reads, so a reference ``.pth`` loads through
:func:`tae_tpu_torch.ckpt.io.load_params` and
:func:`tae_tpu_torch.ckpt.bridge.recognition_state_dict_from_jax` carries the
JAX package's parameters. All 12 reference configs are registered.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tae_tpu_torch.models.registry import register_model
from tae_tpu_torch.nn import init as tinit
from tae_tpu_torch.nn import vit
from tae_tpu_torch.utils.dtypes import DEFAULT, Policy


@dataclasses.dataclass(frozen=True)
class RecognitionConfig:
    num_patches: int = 256
    vocab_size: int = 16
    decoder_embed_dim: int = 768
    decoder_depth: int = 12
    decoder_num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    num_classes: int | None = None   # None -> no head (feature extractor)

    @property
    def block(self) -> vit.BlockConfig:
        return vit.BlockConfig(self.decoder_embed_dim, self.decoder_num_heads,
                               self.mlp_ratio, qkv_bias=True, ln_eps=self.ln_eps)


class LatentTrunk(nn.Module):
    """The embedding, positional embedding, block stack and final LayerNorm
    that the recognition and segmentation models share. Parameters are
    allocated uninitialised on ``device``; :meth:`init_weights_` fills them
    (the reference init: xavier-uniform linears, zero biases, LayerNorm
    ones / zeros, trunc-normal(0.02) positional embedding)."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = c = cfg
        kw = dict(device=device, dtype=dtype)
        self.decoder_embed = vit.Linear(c.vocab_size, c.decoder_embed_dim,
                                        **kw)
        self.decoder_pos_embed = vit.empty_param(
            (1, c.num_patches, c.decoder_embed_dim), **kw)
        self.decoder_blocks = vit.blocks(c.block, c.decoder_depth, **kw)
        self.decoder_norm = vit.LayerNorm(c.decoder_embed_dim, c.ln_eps, **kw)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        vit.init_weights_(self, generator)
        self.decoder_pos_embed.copy_(tinit.trunc_normal(
            generator, self.decoder_pos_embed.shape, std=0.02))
        return self

    def embed(self, z: torch.Tensor, policy: Policy,
              backend: str | None) -> torch.Tensor:
        """(B, N, vocab) latents -> (B, N, D) in the compute dtype, the
        positional embedding added."""
        x = self.decoder_embed(z.to(policy.compute_dtype), backend)
        return x + self.decoder_pos_embed.to(x.dtype)

    def _new_linear(self, in_dim: int, out_dim: int,
                    generator: torch.Generator) -> vit.Linear:
        """A freshly initialised linear on the trunk's device and dtype,
        trainable as the trunk is."""
        ref = self.decoder_embed.weight
        lin = vit.Linear(in_dim, out_dim, device=ref.device, dtype=ref.dtype)
        lin.init_weights_(generator)
        return lin.requires_grad_(ref.requires_grad)


class RecognitionViT(LatentTrunk):
    """``trainable=True`` builds the model for training: every parameter
    requires a gradient (the default builds it frozen)."""

    def __init__(self, cfg: RecognitionConfig, device=None,
                 dtype=torch.float32, trainable: bool = False):
        super().__init__(cfg, device, dtype)
        if cfg.num_classes is not None:
            self.head = vit.Linear(cfg.decoder_embed_dim, cfg.num_classes,
                                   device=device, dtype=dtype)
        self.requires_grad_(trainable)

    def forward_features(self, z: torch.Tensor, *, policy: Policy = DEFAULT,
                         backend: str | None = None,
                         remat: bool | str = False) -> torch.Tensor:
        """(B, N, vocab) -> (B, N, D). Reference tae.py:317-328."""
        x = self.embed(z, policy, backend)
        x = vit.blocks_apply(self.decoder_blocks, x, backend, remat=remat)
        return self.decoder_norm(x, backend)

    def forward_head(self, x: torch.Tensor, backend: str | None = None
                     ) -> torch.Tensor:
        """Mean over the tokens, then the head (reference tae.py:330-333)."""
        x = x.mean(dim=1)
        head = getattr(self, "head", None)
        return x if head is None else head(x, backend)

    def forward(self, z: torch.Tensor, *, policy: Policy = DEFAULT,
                backend: str | None = None, remat: bool | str = False
                ) -> torch.Tensor:
        x = self.forward_features(z, policy=policy, backend=backend,
                                  remat=remat)
        return policy.cast_to_output(self.forward_head(x, backend))

    def replace_head(self, num_classes: int,
                     generator: torch.Generator) -> "RecognitionViT":
        """Head-swap transfer, in place: keep the trunk, give the model a
        freshly initialised head for a new label space (reference
        recognition/train_recognition_in1k.py:126-128)."""
        self.cfg = dataclasses.replace(self.cfg, num_classes=num_classes)
        self.head = self._new_linear(self.cfg.decoder_embed_dim, num_classes,
                                     generator)
        return self


# ---------------------------------------------------------------------------
# Registry: 12 configs, all ViT-Base trunks (reference tae.py:488-537).
# num_patches tracks the TAE patch-size grid: p16 -> 256 ... p128 -> 4 tokens.
# ---------------------------------------------------------------------------

_GRID: dict[int, tuple[int, ...]] = {
    256: (16, 64, 256),
    64: (64, 256, 1024),
    16: (256, 1024, 4096),
    4: (1024, 4096, 16384),
}


def _make_factory(num_patches: int, vocab: int):
    def factory(num_classes: int | None = None, *, device=None,
                dtype=torch.float32, trainable: bool = False,
                **overrides) -> RecognitionViT:
        cfg = RecognitionConfig(num_patches=num_patches, vocab_size=vocab,
                                num_classes=num_classes)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return RecognitionViT(cfg, device=device, dtype=dtype,
                              trainable=trainable)

    return factory


for _n, _vs in _GRID.items():
    for _v in _vs:
        register_model(f"vit_recognition_numpatches{_n}_vocab{_v}_base",
                       _make_factory(_n, _v))
