"""Rank bodies of the multi-process CPU tests (``test_torch_parallel.py``,
``test_torch_adamw_moments.py``): each runs in a process that
``tae_tpu_torch.parallel.spawn`` joined to a gloo group, and returns numpy
values the test compares. This module imports no JAX: the spawned
processes import it by name."""

from __future__ import annotations

import numpy as np
import torch

TINY = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
            vocab_size=16)


def tiny_model(state_dict=None, cfg_kw=TINY):
    from tae_tpu_torch.models.tae import TAE, TAEConfig

    model = TAE(TAEConfig(**cfg_kw), trainable=True)
    if state_dict is None:
        model.init_weights_(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
    return model


def full_params(model) -> dict[str, np.ndarray]:
    """Every parameter whole (an all-gather of each DTensor: every rank
    calls it)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in model.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        out[name] = t.detach().float().numpy().copy()
    return out


def full_moments(opt, model) -> dict[str, tuple[str, np.ndarray, np.ndarray]]:
    """name -> (moment dtype, exp_avg, exp_avg_sq) whole, as float32."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    out = {}
    for name, p in model.named_parameters():
        st = opt.state[p]
        m, v = whole(st["exp_avg"]), whole(st["exp_avg_sq"])
        out[name] = (str(m.dtype), m.float().numpy().copy(),
                     v.float().numpy().copy())
    return out


def train_steps(mesh, state_dict, images: np.ndarray, steps: int,
                moment_dtype=None, weight_decay: float = 0.05):
    """``steps`` train steps of the tiny TAE (FP32, AdamW) on ``images``
    (the global batch), sharded on ``mesh`` (None: one process). Returns
    the global losses, gradient norms, the whole parameters after the last
    step and the state."""
    from tae_tpu_torch.dryrun import global_mean
    from tae_tpu_torch.parallel import batch_slice, shard_model
    from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
    from tae_tpu_torch.utils.dtypes import FP32

    model = shard_model(tiny_model(state_dict), mesh)
    opt = adamw(weight_decay=weight_decay, moment_dtype=moment_dtype)
    state = TrainState.create(model, opt)
    step = make_train_step(lambda m, b: (m(b, policy=FP32)[0], {}), opt,
                           step_lr(1e-3, 1e-4, 100))
    batch = batch_slice(torch.from_numpy(images), mesh)
    losses, norms = [], []
    for it in range(steps):
        state, metrics = step(state, batch, it)
        losses.append(global_mean(metrics["loss"], mesh))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, full_params(model), state


def sharded_train(rank, world, sizes, state_dict, images, steps,
                  weight_decay=0.05):
    from tae_tpu_torch.parallel import make_mesh

    losses, norms, params, _ = train_steps(make_mesh(*sizes), state_dict,
                                           images, steps,
                                           weight_decay=weight_decay)
    return losses, norms, params


def plumbing(rank, world):
    """On a (2, 2, 1) mesh of 4: the mesh itself, each rank's batch rows,
    meter sync, the confusion-matrix sum and ``is_main_process``."""
    from tae_tpu_torch.parallel import batch_slice, is_main_process, make_mesh
    from tae_tpu_torch.parallel.sharding import data_rank
    from tae_tpu_torch.utils.confusion import ConfusionMatrix
    from tae_tpu_torch.utils.meters import SmoothedValue

    mesh = make_mesh(2, 2, 1)
    rows = batch_slice(np.arange(8), mesh)

    meter = SmoothedValue()
    for v in range(rank + 1):
        meter.update(float(10 * rank + v), n=2)
    meter.synchronize_between_processes()
    conf = ConfusionMatrix(3)
    conf.update(np.array([0, 1, 2, 255]), np.array([rank % 3, 1, 0, 1]))
    conf.reduce_from_all_processes()
    return dict(count=meter.count, total=meter.total, mat=conf.mat.copy(),
                main=is_main_process(), names=mesh.mesh_dim_names,
                shape=tuple(mesh.shape), rows=rows.tolist(),
                data_rank=data_rank(mesh))


def save_sharded(rank, world, sizes, state_dict, images, path):
    """Two steps with bf16 moments on ``sizes``, then a checkpoint at
    ``path``; returns the whole parameters and moments that were saved."""
    from tae_tpu_torch.ckpt.io import save_checkpoint
    from tae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(*sizes)
    _, _, params, state = train_steps(mesh, state_dict, images, 2,
                                      torch.bfloat16)
    save_checkpoint(path, state, step=2)
    return params, full_moments(state.opt, state.model)


def restore_sharded(rank, world, sizes, path):
    """A fresh tiny TAE (another seed) and bf16-moment AdamW on ``sizes``,
    restored from ``path``; returns its whole parameters and moments and
    each rank's local parameter shapes."""
    from tae_tpu_torch.ckpt.io import load_train_state
    from tae_tpu_torch.parallel import make_mesh, shard_model
    from tae_tpu_torch.train import TrainState, adamw

    mesh = make_mesh(*sizes) if sizes is not None else None
    model = tiny_model()
    model.init_weights_(torch.Generator().manual_seed(7))
    model = shard_model(model, mesh)
    state = TrainState.create(model, adamw(weight_decay=0.05,
                                           moment_dtype=torch.bfloat16))
    _, restored, meta = load_train_state(path, model, state.opt)
    local = {n: tuple(p.to_local().shape) if mesh is not None
             else tuple(p.shape) for n, p in model.named_parameters()}
    return (restored, meta["step"], full_params(model),
            full_moments(state.opt, model), local)


def restore_one(path):
    return restore_sharded(0, 1, None, path)


def driver(rank, world, module: str, argv: list[str]):
    """``main`` of driver ``module`` on ``argv`` as rank ``rank`` of a
    torchrun launch of ``world`` (its environment set, the group already
    joined); returns what ``main`` returns."""
    import importlib
    import os

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), TAE_TPU_NATIVE="0")
    mod = importlib.import_module(module)
    return mod.main(mod.get_args_parser().parse_args(argv))
