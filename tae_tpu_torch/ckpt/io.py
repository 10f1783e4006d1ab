"""Checkpoint save and restore (counterpart of ``tae_tpu/ckpt/io.py``).

A checkpoint is one ``torch.save`` file: the model's ``state_dict`` (the
reference's key layout), the optimizer's ``state_dict`` when a
:class:`~tae_tpu_torch.train.step.TrainState` was saved, and the metadata
(``step``, ``args``, extras) — the reference's single-file
``torch.save({model, optimizer, args, iteration})``. The metadata is also
written as JSON beside it (``<path>.meta.json``), so the step of a
checkpoint can be read without loading the tensors.

The file is written beside the old one and renamed over it, so a kill at
any point leaves a checkpoint that loads (the old one or the new one).

:func:`load_params` takes such a file or a reference-layout ``.pth`` (both
hold the state_dict under ``"model"``; a bare state_dict works too) and
interpolates positional embeddings whose token grid differs from the
model's. State of the JAX package crosses through
:mod:`tae_tpu_torch.ckpt.bridge`, from numpy arrays; this module reads no
orbax directory.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import torch
from torch import nn

from tae_tpu_torch.ckpt.bridge import state_dict_of
from tae_tpu_torch.ckpt.interpolate import maybe_interpolate_tree

FORMAT = "tae_tpu_torch.checkpoint.v1"


def _meta_path(path: Path) -> Path:
    return path.with_name(path.name + ".meta.json")


def _replace_atomically(write, path: Path) -> None:
    """``write(tmp)`` beside ``path``, then rename over it."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str | Path, state: Any, *, step: int = 0,
                    args: dict | None = None, extra: dict | None = None
                    ) -> None:
    """Save a model (``nn.Module``) or a full ``TrainState`` (model and
    optimizer) with its metadata. Tensors are copied to the host first."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    model = state if isinstance(state, nn.Module) else state.model
    opt = None if isinstance(state, nn.Module) else state.opt
    meta = {"step": int(step), "args": args or {}, **(extra or {})}

    def to_host(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu()
        if isinstance(obj, dict):
            return {k: to_host(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(to_host(v) for v in obj)
        return obj

    blob = {"format": FORMAT, "model": to_host(model.state_dict()),
            "optimizer": None if opt is None else to_host(opt.state_dict()),
            "meta": meta}
    _replace_atomically(lambda tmp: torch.save(blob, tmp), path)
    _replace_atomically(
        lambda tmp: tmp.write_text(json.dumps(meta, indent=2, default=str)),
        _meta_path(path))


def _read(path: str | Path) -> dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def _is_port_checkpoint(blob) -> bool:
    return isinstance(blob, dict) and blob.get("format") == FORMAT


def load_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """``(blob, meta)`` of a port checkpoint, tensors on the host."""
    blob = _read(path)
    if not _is_port_checkpoint(blob):
        raise ValueError(f"{str(path)!r} is not a tae_tpu_torch checkpoint")
    return blob, dict(blob.get("meta") or {})


def promote_checkpoint(src: str | Path, dst: str | Path) -> None:
    """Copy checkpoint ``src`` over ``dst`` by a local file copy and a
    rename: a training loop saves the train state once (the "latest"
    checkpoint) and promotes it to the best-eval path on improvement. A kill
    at any point leaves ``dst`` loadable."""
    src, dst = Path(src).absolute(), Path(dst).absolute()
    dst.parent.mkdir(parents=True, exist_ok=True)
    _replace_atomically(lambda tmp: shutil.copyfile(src, tmp), dst)
    if _meta_path(src).exists():
        _replace_atomically(lambda tmp: shutil.copyfile(_meta_path(src), tmp),
                            _meta_path(dst))


def checkpoint_step(path: str | Path) -> int | None:
    """The saved iteration of a checkpoint, or None if absent or invalid."""
    meta_path = _meta_path(Path(path))
    if not meta_path.exists():
        return None
    try:
        return int(json.loads(meta_path.read_text()).get("step", 0))
    except (ValueError, OSError, json.JSONDecodeError):
        return None


def _load_state_dict(model: nn.Module, blob: dict) -> None:
    """The state_dict of a port checkpoint or a reference-layout ``.pth``
    (under ``"model"``, or bare) into ``model``."""
    own = model.state_dict()
    loaded = maybe_interpolate_tree(state_dict_of(blob), own)
    model.load_state_dict({k: v for k, v in loaded.items() if k in own},
                          strict=False)


def load_params(path: str | Path, model: nn.Module) -> nn.Module:
    """Load ``model``'s parameters, in place, from a port checkpoint or a
    reference-layout ``.pth``, interpolating pos-embeds on a grid mismatch.
    Keys the file lacks keep their current values and keys the model lacks
    are dropped (the reference's ``strict=False`` load); a shape mismatch
    elsewhere raises."""
    _load_state_dict(model, _read(path))
    return model


def load_train_state(path: str | Path, model: nn.Module,
                     opt: torch.optim.Optimizer | None = None
                     ) -> tuple[nn.Module, bool, dict]:
    """Restore ``(model, optimizer restored?, meta)`` in place. A port
    checkpoint saved from a ``TrainState`` restores ``opt`` too (moments
    and step counts, bit for bit); a ``.pth`` or a params-only checkpoint
    restores the parameters only. An optimizer state that does not fit
    (after a head swap, say) is skipped with a message."""
    blob = _read(path)
    _load_state_dict(model, blob)
    if not _is_port_checkpoint(blob):
        return model, False, {}
    restored = False
    if opt is not None and blob.get("optimizer") is not None:
        try:
            opt.load_state_dict(blob["optimizer"])
            restored = True
        except (ValueError, KeyError, RuntimeError) as e:
            print(f"checkpoint optimizer state skipped ({e})")
    return model, restored, dict(blob.get("meta") or {})
