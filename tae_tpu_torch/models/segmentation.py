"""Latent-space dense-prediction ViT with an auxiliary head (counterpart of
``tae_tpu/models/segmentation.py``).

Embeds frozen TAE latents, runs a ViT-Base trunk, taps an auxiliary head
after ``int(0.75 · depth)`` blocks (reference tae.py:358, 416-420) and
unpatchifies both the main and the auxiliary per-patch class logits to dense
(B, num_classes, H, W) maps. :meth:`SegmentationViT.forward` returns
``{"out", "aux"}``, as the reference's OrderedDict (tae.py:413, 426-428).
The block stack runs in two parts split at the tap: blocks ``[0, aux)``,
the auxiliary head on their output, then blocks ``[aux, depth)``.

Submodule names follow the reference's ``state_dict`` keys
(``decoder_embed``, ``decoder_pos_embed``, ``decoder_blocks.{i}.*``,
``decoder_norm``, ``aux_decoder_norm``, ``head``, ``aux_head``).

As in the JAX package, and unlike the reference (whose factories leave the
patch size at 16), the patch size follows the token grid (numpatches 256 /
64 / 16 / 4 -> p 16 / 32 / 64 / 128), so every config predicts at the full
256 px; ``patch_size=16`` reproduces the reference's literal behaviour.
"""

from __future__ import annotations

import dataclasses

import torch

from tae_tpu_torch.models.recognition import LatentTrunk
from tae_tpu_torch.models.registry import register_model
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops.patchify import unpatchify
from tae_tpu_torch.parallel.sharding import constrain_batch
from tae_tpu_torch.utils.dtypes import DEFAULT, Policy


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    num_patches: int = 256
    patch_size: int = 16
    vocab_size: int = 16
    decoder_embed_dim: int = 768
    decoder_depth: int = 12
    decoder_num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    num_classes: int = 21

    @property
    def aux_depth(self) -> int:
        return int(self.decoder_depth * 0.75)

    @property
    def head_dim(self) -> int:
        return self.patch_size ** 2 * self.num_classes

    @property
    def block(self) -> vit.BlockConfig:
        return vit.BlockConfig(self.decoder_embed_dim, self.decoder_num_heads,
                               self.mlp_ratio, qkv_bias=True, ln_eps=self.ln_eps)


class SegmentationViT(LatentTrunk):
    """``trainable=True`` builds the model for training: every parameter
    requires a gradient (the default builds it frozen)."""

    def __init__(self, cfg: SegmentationConfig, device=None,
                 dtype=torch.float32, trainable: bool = False):
        super().__init__(cfg, device, dtype)
        kw = dict(device=device, dtype=dtype)
        self.aux_decoder_norm = vit.LayerNorm(cfg.decoder_embed_dim,
                                              cfg.ln_eps, **kw)
        self.head = vit.Linear(cfg.decoder_embed_dim, cfg.head_dim, **kw)
        self.aux_head = vit.Linear(cfg.decoder_embed_dim, cfg.head_dim, **kw)
        self.requires_grad_(trainable)

    def _dense(self, head, norm, x: torch.Tensor, backend: str | None,
               mesh) -> torch.Tensor:
        """LayerNorm, head, per-patch logits -> (B, C, H, W)."""
        c = self.cfg
        y = constrain_batch(head(norm(x, backend), backend), mesh)
        return constrain_batch(unpatchify(y, c.patch_size, c.num_classes),
                               mesh)

    def forward(self, z: torch.Tensor, *, policy: Policy = DEFAULT,
                backend: str | None = None, remat: bool | str = False,
                mesh=None) -> dict[str, torch.Tensor]:
        """``mesh``: the training mesh, as the JAX package takes it; each
        rank's activations are its own rows, so it passes through
        ``parallel.constrain_batch`` unchanged (sharding is the model's,
        ``parallel.shard_model``)."""
        c = self.cfg
        x = self.embed(z, policy, backend)
        stack = self.decoder_blocks
        # blocks [0, aux), then the auxiliary head (tae.py:416-420); the
        # residual stream stays contiguous, as the LayerNorm kernel reads it
        x = vit.blocks_apply(stack[:c.aux_depth], x, backend, remat=remat)
        aux = self._dense(self.aux_head, self.aux_decoder_norm, x, backend,
                          mesh)
        x = vit.blocks_apply(stack[c.aux_depth:], x, backend, remat=remat)
        out = self._dense(self.head, self.decoder_norm, x, backend, mesh)
        return {"out": policy.cast_to_output(out),
                "aux": policy.cast_to_output(aux)}

    def replace_head(self, num_classes: int,
                     generator: torch.Generator) -> "SegmentationViT":
        """Swap both dense heads for a new class count, in place (reference
        segmentation/train.py:156-157)."""
        self.cfg = dataclasses.replace(self.cfg, num_classes=num_classes)
        d, h = self.cfg.decoder_embed_dim, self.cfg.head_dim
        self.head = self._new_linear(d, h, generator)
        self.aux_head = self._new_linear(d, h, generator)
        return self


# ---------------------------------------------------------------------------
# Registry: 12 configs (reference tae.py:542-591), the patch size from the
# token grid (see the module docstring).
# ---------------------------------------------------------------------------

_GRID: dict[int, tuple[int, tuple[int, ...]]] = {
    256: (16, (16, 64, 256)),
    64: (32, (64, 256, 1024)),
    16: (64, (256, 1024, 4096)),
    4: (128, (1024, 4096, 16384)),
}


def _make_factory(num_patches: int, patch_size: int, vocab: int):
    def factory(num_classes: int | None = None, *, device=None,
                dtype=torch.float32, trainable: bool = False,
                **overrides) -> SegmentationViT:
        cfg = SegmentationConfig(
            num_patches=num_patches, patch_size=patch_size, vocab_size=vocab,
            num_classes=21 if num_classes is None else num_classes)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return SegmentationViT(cfg, device=device, dtype=dtype,
                               trainable=trainable)

    return factory


for _n, (_p, _vs) in _GRID.items():
    for _v in _vs:
        register_model(f"vit_segmentation_numpatches{_n}_vocab{_v}_base",
                       _make_factory(_n, _p, _v))
