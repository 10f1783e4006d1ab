"""Weight bridge into the port's ``state_dict`` (counterpart of
``tae_tpu/ckpt/torch_export.py``).

:func:`state_dict_from_jax` turns a ``tae_tpu`` TAE parameter tree, given as
numpy arrays with depth-stacked blocks, into the reference-layout
``state_dict`` that :class:`tae_tpu_torch.models.tae.TAE` loads with
``strict=True``:

  * Linear ``{w: (in, out), b}`` -> ``weight (out, in)`` / ``bias``;
  * patch-embed matmul weight ``(C·p², E)`` -> Conv2d-shaped ``(E, C, p, p)``;
  * LayerNorm ``{scale, bias}`` -> ``weight`` / ``bias``;
  * depth-stacked block arrays -> per-layer ``blocks.{i}.*`` entries, with
    ``attn.q_norm`` / ``attn.k_norm`` where the blocks have qk_norm.

:func:`blocks_state_dict_from_jax` does the same for a bare block stack
(``tae_tpu.nn.vit.blocks_init``), keyed as ``nn.vit.blocks`` holds it, and
:func:`recognition_state_dict_from_jax` / :func:`segmentation_state_dict_from_jax`
for the downstream models' trees (``tae_tpu.models.recognition`` /
``segmentation``), keyed as the reference's classifier and segmenter (the
keys ``tae_tpu/ckpt/torch_import.py`` reads).

:func:`serving_state_dict_from_jax` does the same for the JAX package's
int8 and int4 serving trees (quantized linears ``{w_q (in, out) int8,
w_scale (out,), b}`` or ``{w4 (in/2, out) packed bytes, w4_scale (in/G, out),
b}``, blocks as a list of per-layer trees), so both packages can hold
bit-identical codes and scales. The int4 bytes are unpacked by the JAX
package's rule (nibble planes, offset-8 low nibble) and packed again in the
port's layout (:func:`tae_tpu_torch.ops.cuda.int4_matmul.pack_int4`). A
top-level ``codebook`` leaf (the VQ bottleneck) is carried as it is.

The mapping is elementwise per parameter, so the same function turns any
tree shaped like the parameters into the port's layout: a gradient tree, or
the moments of the JAX package's ``AdamWState``
(:func:`load_adamw_state_from_jax`). That is how training state crosses: as
numpy arrays through this module; the port reads no orbax directory.

:func:`act_amax_from_jax` carries the JAX package's calibration statistics
(``tae_tpu.calibrate.ln_amax``) into the port's keys, so measured
activation ranges cross as weights do.

A JAX-trained checkpoint can also reach the port as a ``.pth`` written by
``python -m tae_tpu.cli.export_torch``; :func:`state_dict_of` finds the
state_dict in either form of such a file, and in a checkpoint of the port's
own (:func:`tae_tpu_torch.ckpt.io.load_params` loads them).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

Params = Mapping[str, Any]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _repack_int4(w4) -> torch.Tensor:
    """JAX packed bytes (K/2, N) int8, byte row r = 16 * w[r + K/2] +
    (w[r] + 8) -> the port's (N, K/2) uint8."""
    from tae_tpu_torch.ops.cuda.int4_matmul import pack_int4

    b = np.asarray(w4).astype(np.int32)             # sign-extended
    q = np.concatenate([(b & 15) - 8, b >> 4], axis=0)            # (K, N)
    return pack_int4(torch.from_numpy(np.ascontiguousarray(q.T).astype(np.int8)))


def _linear(out: dict, prefix: str, p: Params) -> None:
    if "w4" in p:
        out[f"{prefix}.w4"] = _repack_int4(p["w4"])
        out[f"{prefix}.w4_scale"] = _t(p["w4_scale"])
    elif "w_q" in p:
        wq = np.ascontiguousarray(np.asarray(p["w_q"], dtype=np.int8).T)
        out[f"{prefix}.w_q"] = torch.from_numpy(wq)
        out[f"{prefix}.w_scale"] = _t(p["w_scale"])
    else:
        out[f"{prefix}.weight"] = _t(p["w"]).T.contiguous()
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])


def _layer_norm(out: dict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _blocks(out: dict, prefix: str, blocks) -> None:
    """Depth-stacked block arrays, or a list of per-layer trees."""
    if isinstance(blocks, (list, tuple)):
        layers = list(blocks)
    else:
        depth = int(np.asarray(blocks["norm1"]["scale"]).shape[0])
        layers = [_tree_index(blocks, i) for i in range(depth)]
    for i, layer in enumerate(layers):
        b = f"{prefix}.{i}"
        _layer_norm(out, f"{b}.norm1", layer["norm1"])
        _linear(out, f"{b}.attn.qkv", layer["attn"]["qkv"])
        if "q_norm" in layer["attn"]:       # qk_norm (reference tae.py:68-69)
            _layer_norm(out, f"{b}.attn.q_norm", layer["attn"]["q_norm"])
            _layer_norm(out, f"{b}.attn.k_norm", layer["attn"]["k_norm"])
        _linear(out, f"{b}.attn.proj", layer["attn"]["proj"])
        _layer_norm(out, f"{b}.norm2", layer["norm2"])
        _linear(out, f"{b}.mlp.fc1", layer["mlp"]["fc1"])
        _linear(out, f"{b}.mlp.fc2", layer["mlp"]["fc2"])


def blocks_state_dict_from_jax(blocks_np) -> dict[str, torch.Tensor]:
    """A ``tae_tpu`` block stack (depth-stacked numpy leaves, or a list of
    per-layer trees) -> the state_dict of ``tae_tpu_torch.nn.vit.blocks``
    (keys ``{i}.*``), fp32 tensors on the CPU."""
    sd: dict[str, torch.Tensor] = {}
    _blocks(sd, "", blocks_np)
    return {k[1:]: v for k, v in sd.items()}


def _tree_index(tree: Params, i: int) -> dict:
    return {k: _tree_index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def _patch_embed(out: dict, prefix: str, p: Params, patch: int,
                 in_chans: int) -> None:
    if "w_q" in p:      # quantized: applied as the plain matrix (E, C·p²)
        return _linear(out, prefix, p)
    w = np.asarray(p["w"], dtype=np.float32)          # (C·p², E)
    e = w.shape[1]
    out[f"{prefix}.weight"] = _t(w.T.reshape(e, in_chans, patch, patch))
    out[f"{prefix}.bias"] = _t(p["b"])


def state_dict_from_jax(params_np: Params, cfg) -> dict[str, torch.Tensor]:
    """``tae_tpu`` TAE parameter tree (numpy leaves; either half may be
    absent) -> the port's state_dict, fp32 tensors on the CPU."""
    sd: dict[str, torch.Tensor] = {}
    enc, dec = params_np.get("encoder"), params_np.get("decoder")
    if enc is not None:
        _patch_embed(sd, "patch_embed.proj", enc["patch_embed"],
                     cfg.patch_size, cfg.in_chans)
        sd["pos_embed"] = _t(enc["pos_embed"])
        _blocks(sd, "blocks", enc["blocks"])
        _layer_norm(sd, "norm", enc["norm"])
        _linear(sd, "dict_proj", enc["dict_proj"])
    if dec is not None:
        _linear(sd, "decoder_embed", dec["embed"])
        sd["decoder_pos_embed"] = _t(dec["pos_embed"])
        _blocks(sd, "decoder_blocks", dec["blocks"])
        _layer_norm(sd, "decoder_norm", dec["norm"])
        _linear(sd, "decoder_pred", dec["pred"])
    if "codebook" in params_np:
        sd["codebook"] = _t(params_np["codebook"])
    return sd


def _latent_trunk(out: dict, p: Params) -> None:
    _linear(out, "decoder_embed", p["embed"])
    out["decoder_pos_embed"] = _t(p["pos_embed"])
    _blocks(out, "decoder_blocks", p["blocks"])
    _layer_norm(out, "decoder_norm", p["norm"])


def recognition_state_dict_from_jax(params_np: Params, cfg=None
                                    ) -> dict[str, torch.Tensor]:
    """A ``tae_tpu`` ``RecognitionViT`` tree (numpy leaves, depth-stacked
    blocks; ``head`` absent for a feature extractor) -> the state_dict of
    :class:`tae_tpu_torch.models.recognition.RecognitionViT`, fp32 tensors
    on the CPU. ``cfg`` is accepted for symmetry with the JAX importer."""
    sd: dict[str, torch.Tensor] = {}
    _latent_trunk(sd, params_np)
    if "head" in params_np:
        _linear(sd, "head", params_np["head"])
    return sd


def segmentation_state_dict_from_jax(params_np: Params, cfg=None
                                     ) -> dict[str, torch.Tensor]:
    """A ``tae_tpu`` ``SegmentationViT`` tree -> the state_dict of
    :class:`tae_tpu_torch.models.segmentation.SegmentationViT`."""
    sd: dict[str, torch.Tensor] = {}
    _latent_trunk(sd, params_np)
    _layer_norm(sd, "aux_decoder_norm", params_np["aux_norm"])
    _linear(sd, "head", params_np["head"])
    _linear(sd, "aux_head", params_np["aux_head"])
    return sd


def serving_state_dict_from_jax(params_np: Params, cfg
                                ) -> dict[str, torch.Tensor]:
    """The JAX package's quantized, unstacked serving tree (numpy leaves;
    the output of its ``prepare_serving_params``) -> the state_dict of the
    port's model after ``quantize_params_`` / ``quantize_params_int4_``:
    int8 codes transposed to (out, in) bit for bit, int4 codes repacked,
    fp32 scales, float leaves as fp32."""
    return state_dict_from_jax(params_np, cfg)


def load_adamw_state_from_jax(opt: torch.optim.Optimizer, model, step: int,
                              mu_np: Params, nu_np: Params) -> None:
    """Fill the port's AdamW state (``opt``, made by
    ``tae_tpu_torch.train.adamw(...).init(model)``) from the JAX package's
    ``AdamWState``: its ``step`` and its ``mu`` / ``nu`` trees as numpy
    arrays, laid out like the parameters."""
    from tae_tpu_torch.train.optim import set_adamw_state

    set_adamw_state(opt, model, int(step),
                    state_dict_from_jax(mu_np, model.cfg),
                    state_dict_from_jax(nu_np, model.cfg))


def act_amax_from_jax(stats_np: Params) -> dict[str, torch.Tensor]:
    """The JAX package's calibration statistics (the tree
    ``tae_tpu.calibrate.ln_amax`` returns, numpy leaves: ``x_amax`` under
    each equalized linear, depth-stacked ``(depth, D)`` in the blocks) ->
    the port's ``{linear name: (D,) fp32 tensor}``, the form
    :func:`tae_tpu_torch.calibrate.ln_amax` returns and
    ``equalize_params_(act_amax=)`` reads."""
    out: dict[str, torch.Tensor] = {}
    for half, prefix, head, port_head in (
            ("encoder", "blocks", "dict_proj", "dict_proj"),
            ("decoder", "decoder_blocks", "pred", "decoder_pred")):
        s = stats_np.get(half)
        if s is None:
            continue
        blocks = s.get("blocks")
        if blocks is not None:
            for lin, path in (("attn.qkv", ("attn", "qkv")),
                              ("mlp.fc1", ("mlp", "fc1"))):
                stacked = np.asarray(blocks[path[0]][path[1]]["x_amax"])
                for i, row in enumerate(stacked):
                    out[f"{prefix}.{i}.{lin}"] = _t(row)
        if head in s:
            out[port_head] = _t(s[head]["x_amax"])
    return out


def state_dict_of(blob) -> dict[str, torch.Tensor]:
    """The state_dict in a loaded file: under ``"model"`` (the reference's
    and ``export_torch``'s on-disk form, and the port's own checkpoints) or
    the file itself (a bare state_dict)."""
    return blob["model"] if "model" in blob else blob
