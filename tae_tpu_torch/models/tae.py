"""TAE — transformer autoencoder image tokenizer (counterpart of
``tae_tpu/models/tae.py``).

A ViT encoder ending in a bias-free ``dict_proj`` down to ``vocab_size``
channels (the continuous bottleneck), and a ViT decoder reading it back up
to per-patch pixel predictions; the training objective is the fp32 mean MSE
in patch space. Submodule names follow the reference's ``state_dict`` keys
(``patch_embed.proj.weight`` (E, C, p, p), ``pos_embed``,
``blocks.{i}.attn.qkv.weight``, ``dict_proj.weight``, ``decoder_embed.*``,
``decoder_blocks.{i}.*``, ``decoder_norm.*``, ``decoder_pred.*``), so one
``load_state_dict(strict=True)`` takes both a reference ``.pth`` and the
output of :func:`tae_tpu_torch.ckpt.bridge.state_dict_from_jax`.

``quantize=True`` adds the VQ bottleneck (off by default): a ``codebook``
parameter (codebook_size, vocab_size) shared by both halves, through which
:meth:`TAE.forward` passes the latents with a straight-through gradient
(:func:`tae_tpu_torch.ops.quantizer.vq_ste`), adding the codebook and
commitment losses to the objective.

All 12 reference configs are registered under their original names.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tae_tpu_torch.models.registry import register_model
from tae_tpu_torch.nn import init as tinit
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops.patchify import patchify, unpatchify
from tae_tpu_torch.utils.dtypes import DEFAULT, Policy

#: submodules and parameters of each half, as named in the state_dict
ENCODER_PARTS = ("patch_embed", "pos_embed", "blocks", "norm", "dict_proj")
DECODER_PARTS = ("decoder_embed", "decoder_pos_embed", "decoder_blocks",
                 "decoder_norm", "decoder_pred")


@dataclasses.dataclass(frozen=True)
class TAEConfig:
    img_size: int = 256
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1024
    vocab_size: int = 16
    depth: int = 15
    num_heads: int = 16
    decoder_embed_dim: int = 1024
    decoder_depth: int = 15
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    quantize: bool = False
    codebook_size: int = 8192
    commitment_beta: float = 0.25

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def enc_block(self) -> vit.BlockConfig:
        return vit.BlockConfig(self.embed_dim, self.num_heads, self.mlp_ratio,
                               qkv_bias=True, ln_eps=self.ln_eps)

    @property
    def dec_block(self) -> vit.BlockConfig:
        return vit.BlockConfig(self.decoder_embed_dim, self.decoder_num_heads,
                               self.mlp_ratio, qkv_bias=True,
                               ln_eps=self.ln_eps)


class TAE(nn.Module):
    """Parameters are allocated uninitialised on ``device`` (``"meta"``
    allocates nothing); :meth:`init_weights_` fills them from a generator,
    or ``load_state_dict`` from a checkpoint. ``trainable=True`` builds the
    model for training: every parameter requires a gradient (the default
    builds it frozen, for serving)."""

    def __init__(self, cfg: TAEConfig, device=None, dtype=torch.float32,
                 trainable: bool = False):
        super().__init__()
        self.cfg = c = cfg
        kw = dict(device=device, dtype=dtype)
        n = c.num_patches
        self.patch_embed = vit.PatchEmbed(c.patch_size, c.in_chans,
                                          c.embed_dim, **kw)
        self.pos_embed = vit.empty_param((1, n, c.embed_dim), **kw)
        self.blocks = vit.blocks(c.enc_block, c.depth, **kw)
        self.norm = vit.LayerNorm(c.embed_dim, c.ln_eps, **kw)
        self.dict_proj = vit.Linear(c.embed_dim, c.vocab_size, bias=False,
                                    **kw)
        self.decoder_embed = vit.Linear(c.vocab_size, c.decoder_embed_dim,
                                        **kw)
        self.decoder_pos_embed = vit.empty_param((1, n, c.decoder_embed_dim),
                                                 **kw)
        self.decoder_blocks = vit.blocks(c.dec_block, c.decoder_depth, **kw)
        self.decoder_norm = vit.LayerNorm(c.decoder_embed_dim, c.ln_eps, **kw)
        self.decoder_pred = vit.Linear(c.decoder_embed_dim,
                                       c.patch_size ** 2 * c.in_chans, **kw)
        if c.quantize:
            self.codebook = vit.empty_param((c.codebook_size, c.vocab_size),
                                            **kw)
        self.requires_grad_(trainable)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "TAE":
        """Reference init: xavier-uniform linears, zero biases, LayerNorm
        ones/zeros, trunc-normal(0.02) positional embeddings; the codebook
        uniform in +-1 / codebook_size."""
        vit.init_weights_(self, generator)
        for name in ("pos_embed", "decoder_pos_embed"):
            p = getattr(self, name, None)
            if p is not None:
                p.copy_(tinit.trunc_normal(generator, p.shape, std=0.02))
        if self.cfg.quantize:
            bound = 1.0 / self.cfg.codebook_size
            u = torch.rand(self.codebook.shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
            self.codebook.copy_((2.0 * u - 1.0) * bound)
        return self

    @property
    def has_encoder(self) -> bool:
        return hasattr(self, "blocks")

    @property
    def has_decoder(self) -> bool:
        return hasattr(self, "decoder_blocks")

    # --------------------------------------------------------------- forward
    def forward_encoder(self, imgs: torch.Tensor, *, policy: Policy = DEFAULT,
                        backend: str | None = None, serving: bool = False,
                        remat: bool | str = False) -> torch.Tensor:
        """(B, C, H, W) images, or (B, N, C·p²) rows in ``extract_patches``
        layout -> latents (B, N, vocab_size)."""
        c = self.cfg
        if imgs.ndim == 3:
            expect = (c.num_patches, c.patch_size ** 2 * c.in_chans)
            if tuple(imgs.shape[1:]) != expect:
                raise ValueError(f"pre-patchified input {tuple(imgs.shape[1:])} "
                                 f"doesn't match model {expect}")
        elif tuple(imgs.shape[-2:]) != (c.img_size, c.img_size):
            raise ValueError(
                f"input image size {tuple(imgs.shape[-2:])} doesn't match "
                f"model img_size {c.img_size} (reference tae.py:48-49 "
                "semantics)")
        x = self.patch_embed(imgs.to(policy.compute_dtype), backend)
        x = x + self.pos_embed.to(x.dtype)
        x = self._blocks_then_head(self.blocks, self.norm, self.dict_proj, x,
                                   policy, backend, serving, remat)
        return policy.cast_to_output(x)

    def forward_decoder(self, z: torch.Tensor, *, policy: Policy = DEFAULT,
                        backend: str | None = None, serving: bool = False,
                        remat: bool | str = False) -> torch.Tensor:
        """latents (B, N, vocab) -> per-patch pixel predictions (B, N, p²·C)."""
        x = self.decoder_embed(z.to(policy.compute_dtype), backend)
        x = x + self.decoder_pos_embed.to(x.dtype)
        x = self._blocks_then_head(self.decoder_blocks, self.decoder_norm,
                                   self.decoder_pred, x, policy, backend,
                                   serving, remat)
        return policy.cast_to_output(x)

    @staticmethod
    def _blocks_then_head(stack, norm, head, x: torch.Tensor, policy: Policy,
                          backend: str | None, serving: bool,
                          remat: bool | str = False) -> torch.Tensor:
        """Block stack -> final LayerNorm -> head linear. With a quantized
        head the final LayerNorm + quantize chain into the last int8
        block's MLP epilogue and the head reads the ``(xq, sx)`` directly."""
        if not isinstance(head, vit.QLinear):
            x = vit.blocks_apply(stack, x, backend, serving, remat=remat)
            return head(norm(x, backend), backend)
        x, ln = vit.blocks_apply(stack, x, backend, serving, final_norm=norm,
                                 remat=remat)
        if ln is None:
            return head(norm(x, backend), backend)
        xq, sx = ln
        b, n, _ = x.shape
        y = head(xq, backend, x_scale=sx, out_dtype=policy.compute_dtype)
        return y.reshape(b, n, -1)

    def forward_loss(self, imgs: torch.Tensor,
                     pred: torch.Tensor) -> torch.Tensor:
        """Mean per-pixel MSE in patch space, in fp32."""
        target = patchify(imgs, self.cfg.patch_size).float()
        return (pred.float() - target).square().mean()

    def forward(self, imgs: torch.Tensor, *, policy: Policy = DEFAULT,
                backend: str | None = None, remat: bool | str = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full autoencode: returns (loss, pred), the training objective.
        ``remat=True`` recomputes each block in the backward pass
        (:func:`tae_tpu_torch.nn.vit.blocks_apply`). With ``quantize=True``
        the latents pass through the VQ bottleneck and the loss gains the
        codebook and commitment terms."""
        z = self.forward_encoder(imgs, policy=policy, backend=backend,
                                 remat=remat)
        aux = 0.0
        if self.cfg.quantize:
            from tae_tpu_torch.ops.quantizer import vq_ste

            z, aux = vq_ste(z, self.codebook, self.cfg.commitment_beta,
                            backend)
        pred = self.forward_decoder(z, policy=policy, backend=backend,
                                    remat=remat)
        return self.forward_loss(imgs, pred) + aux, pred

    # ----------------------------------------------------------------- utils
    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        return patchify(imgs, self.cfg.patch_size)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        return unpatchify(x, self.cfg.patch_size, self.cfg.in_chans)


# ---------------------------------------------------------------------------
# Registry: the 12 reference configs (reference tae.py:434-483).
# ---------------------------------------------------------------------------

_TRUNKS: dict[int, dict[str, int]] = {
    16: dict(embed_dim=1024, depth=15, num_heads=16),
    32: dict(embed_dim=2048, depth=18, num_heads=32),
    64: dict(embed_dim=2560, depth=21, num_heads=32),
    128: dict(embed_dim=2560, depth=22, num_heads=32),
}

_VOCABS: dict[int, tuple[int, ...]] = {
    16: (16, 64, 256),
    32: (64, 256, 1024),
    64: (256, 1024, 4096),
    128: (1024, 4096, 16384),
}


def _make_factory(patch: int, vocab: int):
    trunk = _TRUNKS[patch]

    def factory(*, device=None, dtype=torch.float32, trainable: bool = False,
                **overrides) -> TAE:
        cfg = TAEConfig(
            img_size=256,
            patch_size=patch,
            vocab_size=vocab,
            embed_dim=trunk["embed_dim"],
            depth=trunk["depth"],
            num_heads=trunk["num_heads"],
            decoder_embed_dim=trunk["embed_dim"],
            decoder_depth=trunk["depth"],
            decoder_num_heads=trunk["num_heads"],
            mlp_ratio=4.0,
            ln_eps=1e-6,
        )
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return TAE(cfg, device=device, dtype=dtype, trainable=trainable)

    return factory


for _p, _vs in _VOCABS.items():
    for _v in _vs:
        register_model(f"tae_patch{_p}_vocab{_v}_px256", _make_factory(_p, _v))
