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

Under a mesh (a model placed by ``parallel.shard_model``: DTensor
parameters) the same single file is written: every rank takes part in
gathering the full model and optimizer state to rank 0
(``torch.distributed.checkpoint.state_dict``, ``full_state_dict=True``,
``cpu_offload=True``), rank 0 writes it, with barriers around the rename.
A block split over ``tensor`` groups its qkv rows by rank; the gathered
tensors are put back in the reference's rows before they are written, and
a loaded one is grouped again before it is placed
(:mod:`tae_tpu_torch.parallel.tensor`). On load every rank reads the file
and sets the full state onto its own shards, so a checkpoint saved on one
mesh restores on another, or in one process, and the reverse. The optimizer state keeps torch's layout
(integer keys in the order of the optimizer's parameter groups) whatever
the mesh; reduced-precision moments keep their type.

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
from tae_tpu_torch.parallel.sharding import is_sharded
from tae_tpu_torch.parallel.tensor import to_ranks, to_reference

FORMAT = "tae_tpu_torch.checkpoint.v1"


def _meta_path(path: Path) -> Path:
    return path.with_name(path.name + ".meta.json")


def _replace_atomically(write, path: Path) -> None:
    """``write(tmp)`` beside ``path``, then rename over it."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _full_options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, **kw)


def _param_names(model: nn.Module, opt: torch.optim.Optimizer) -> list[str]:
    """The names of ``opt``'s parameters in the order of its groups: the
    order of torch's integer state keys."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in opt.param_groups for p in g["params"]]


def _model_state(model: nn.Module) -> dict:
    if not is_sharded(model):
        return _to_host(model.state_dict())
    from torch.distributed.checkpoint.state_dict import get_model_state_dict

    return to_reference(get_model_state_dict(
        model, options=_full_options(cpu_offload=True)), model)


def _optimizer_state(model: nn.Module, opt: torch.optim.Optimizer) -> dict:
    """torch's ``opt.state_dict()`` layout on the host, gathered from the
    ranks' shards under a mesh (rank 0 gets it, the others an empty dict)."""
    if not is_sharded(model):
        return _to_host(opt.state_dict())
    from torch.distributed.checkpoint.state_dict import get_optimizer_state_dict

    by_name = get_optimizer_state_dict(model, opt,
                                       options=_full_options(cpu_offload=True))
    if not by_name:
        return {}
    names = [n for g in by_name["param_groups"] for n in g["params"]]
    index = {n: i for i, n in enumerate(names)}
    state = to_reference(by_name["state"], model)
    return {"state": {index[n]: st for n, st in state.items()},
            "param_groups": [dict(g, params=[index[n] for n in g["params"]])
                             for g in by_name["param_groups"]]}


def save_checkpoint(path: str | Path, state: Any, *, step: int = 0,
                    args: dict | None = None, extra: dict | None = None
                    ) -> None:
    """Save a model (``nn.Module``) or a full ``TrainState`` (model and
    optimizer) with its metadata. Tensors are copied to the host first.
    Under a mesh every rank calls it and rank 0 writes."""
    from tae_tpu_torch.parallel.mesh import barrier, is_main_process

    path = Path(path).absolute()
    model = state if isinstance(state, nn.Module) else state.model
    opt = None if isinstance(state, nn.Module) else state.opt
    meta = {"step": int(step), "args": args or {}, **(extra or {})}
    blob = {"format": FORMAT, "model": _model_state(model),
            "optimizer": None if opt is None else _optimizer_state(model, opt),
            "meta": meta}
    barrier()
    if is_main_process():
        path.parent.mkdir(parents=True, exist_ok=True)
        _replace_atomically(lambda tmp: torch.save(blob, tmp), path)
        _replace_atomically(
            lambda tmp: tmp.write_text(json.dumps(meta, indent=2, default=str)),
            _meta_path(path))
    barrier()


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
    at any point leaves ``dst`` loadable. Rank 0 copies; every rank waits.
    """
    from tae_tpu_torch.parallel.mesh import barrier, is_main_process

    src, dst = Path(src).absolute(), Path(dst).absolute()
    if is_main_process():
        dst.parent.mkdir(parents=True, exist_ok=True)
        _replace_atomically(lambda tmp: shutil.copyfile(src, tmp), dst)
        if _meta_path(src).exists():
            _replace_atomically(
                lambda tmp: shutil.copyfile(_meta_path(src), tmp),
                _meta_path(dst))
    barrier()


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
    loaded = {k: v for k, v in loaded.items() if k in own}
    if not is_sharded(model):
        model.load_state_dict(loaded, strict=False)
        return
    from torch.distributed.checkpoint.state_dict import set_model_state_dict

    set_model_state_dict(model, to_ranks(loaded, model),
                         options=_full_options(strict=False))


def _load_optimizer(model: nn.Module, opt: torch.optim.Optimizer,
                    saved: dict) -> None:
    """torch's layout into ``opt``; under a mesh each rank keeps its shard."""
    if not is_sharded(model):
        opt.load_state_dict(saved)
        return
    from torch.distributed.checkpoint.state_dict import set_optimizer_state_dict

    names = _param_names(model, opt)
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    if len(ids) != len(names):
        raise ValueError(f"the checkpoint's optimizer has {len(ids)} "
                         f"parameters, this one {len(names)}")
    name = dict(zip(ids, names))
    state = {name[i]: st for i, st in saved["state"].items()}
    by_name = {"state": to_ranks(state, model),
               "param_groups": [dict(g, params=[name[i] for i in g["params"]])
                                for g in saved["param_groups"]]}
    set_optimizer_state_dict(model, opt, by_name, options=_full_options())


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
            _load_optimizer(model, opt, blob["optimizer"])
            restored = True
        except (ValueError, KeyError, RuntimeError) as e:
            print(f"checkpoint optimizer state skipped ({e})")
    return model, restored, dict(blob.get("meta") or {})
