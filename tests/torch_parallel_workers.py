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


def _whole(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def full_params(model) -> dict[str, np.ndarray]:
    """Every parameter whole (an all-gather of each DTensor: every rank
    calls it), a split qkv in the reference's rows."""
    from tae_tpu_torch.parallel.tensor import to_reference

    whole = to_reference({name: _whole(p) for name, p in
                          model.named_parameters()}, model)
    return {name: t.float().numpy().copy() for name, t in whole.items()}


def full_moments(opt, model) -> dict[str, tuple[str, np.ndarray, np.ndarray]]:
    """name -> (moment dtype, exp_avg, exp_avg_sq) whole, as float32, a
    split qkv's in the reference's rows."""
    from tae_tpu_torch.parallel.tensor import to_reference

    state = to_reference({name: {k: _whole(opt.state[p][k]) for k in
                                 ("exp_avg", "exp_avg_sq")}
                          for name, p in model.named_parameters()}, model)
    return {name: (str(st["exp_avg"].dtype),
                   st["exp_avg"].float().numpy().copy(),
                   st["exp_avg_sq"].float().numpy().copy())
            for name, st in state.items()}


def train_steps(mesh, state_dict, images: np.ndarray, steps: int,
                moment_dtype=None, weight_decay: float = 0.05,
                cfg_kw=TINY):
    """``steps`` train steps of the tiny TAE (FP32, AdamW; ``cfg_kw`` its
    config) on ``images`` (the global batch), sharded on ``mesh`` (None:
    one process). Returns the global losses, gradient norms, the whole
    parameters after the last step and the state."""
    from tae_tpu_torch.dryrun import global_mean
    from tae_tpu_torch.parallel import batch_slice, shard_model
    from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
    from tae_tpu_torch.utils.dtypes import FP32

    model = shard_model(tiny_model(state_dict, cfg_kw), mesh)
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


# ------------------------------------------------------- the tensor axis

class QkNormStack(torch.nn.Module):
    """Two qk_norm blocks (width 64, 4 heads) and a squared-error loss."""

    def __init__(self):
        super().__init__()
        from tae_tpu_torch.nn.vit import BlockConfig, blocks

        self.blocks = blocks(BlockConfig(64, 4, qk_norm=True), 2)
        for p in self.parameters():
            p.requires_grad_(True)

    def forward(self, x):
        from tae_tpu_torch.nn.vit import blocks_apply

        return (blocks_apply(self.blocks, x) - x).square().mean()


def qk_norm_steps(mesh, x: np.ndarray, steps: int):
    """``steps`` AdamW steps of :class:`QkNormStack` (seed 5) on rows ``x``
    (the global batch): the losses, gradient norms and whole parameters."""
    from tae_tpu_torch.dryrun import global_mean
    from tae_tpu_torch.nn.vit import init_weights_
    from tae_tpu_torch.parallel import batch_slice, shard_model
    from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr

    model = QkNormStack()
    init_weights_(model, torch.Generator().manual_seed(5))
    model = shard_model(model, mesh)
    opt = adamw(weight_decay=0.05)
    state = TrainState.create(model, opt)
    step = make_train_step(lambda m, b: (m(b), {}), opt,
                           step_lr(1e-3, 1e-4, 100))
    batch = batch_slice(torch.from_numpy(x), mesh)
    losses, norms = [], []
    for it in range(steps):
        state, metrics = step(state, batch, it)
        losses.append(global_mean(metrics["loss"], mesh))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, full_params(model)


def encode_tiny(mesh, images: np.ndarray) -> np.ndarray:
    """fp32 latents of ``images`` through ``Tokenizer.from_checkpoint``
    of the tiny TAE (seed 0), on ``mesh``."""
    from tae_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer.from_checkpoint("tae_patch16_vocab16_px256", device="cpu",
                                    dtype=torch.float32, mesh=mesh, **TINY)
    return tok.encode(torch.from_numpy(images)).numpy()


#: the fallback's model: 3 heads, which a tensor axis of 2 does not divide
THREE_HEADS = dict(TINY, embed_dim=48, num_heads=3, decoder_embed_dim=48,
                   decoder_num_heads=3)


def split_checks(rank, world, state_dict, images, rows, path):
    """On a (1, 1, 2) mesh: the tiny TAE split (``state_dict`` loaded),
    its local qkv rows, its head count and a checkpoint of it at ``path``;
    two steps of the qk_norm stack on ``rows``; two steps of the 3-head
    TAE, whose blocks stay whole; the tiny Tokenizer's latents."""
    from tae_tpu_torch.ckpt.io import save_checkpoint
    from tae_tpu_torch.parallel import make_mesh, shard_model

    mesh = make_mesh(1, 1, 2)
    model = shard_model(tiny_model(state_dict), mesh)
    attn = model.blocks[0].attn
    local_qkv = attn.qkv.weight.to_local().detach().numpy().copy()
    local_proj = attn.proj.weight.to_local().detach().numpy().copy()
    save_checkpoint(path, model)
    fallback = train_steps(mesh, None, images, 2, cfg_kw=THREE_HEADS)[:3]
    return dict(heads=attn.num_heads, qkv=local_qkv, proj=local_proj,
                qk_norm=qk_norm_steps(mesh, rows, 2), fallback=fallback,
                latents=encode_tiny(mesh, images))


def tensor_plumbing(rank, world, shards: str):
    """On a (2, 1, 2) mesh of 4: each rank's rows, meters, confusion
    matrices, means over ranks and the train loader's rows, tensor peers
    counted once."""
    import os
    import types

    from tae_tpu_torch.cli import _common
    from tae_tpu_torch.parallel import batch_slice, is_main_process, make_mesh
    from tae_tpu_torch.parallel.mesh import all_reduce_sum, tensor_rank
    from tae_tpu_torch.parallel.sharding import data_rank
    from tae_tpu_torch.utils.confusion import ConfusionMatrix
    from tae_tpu_torch.utils.meters import SmoothedValue

    os.environ["TAE_TPU_NATIVE"] = "0"
    mesh = make_mesh(2, 1, 2)
    index, _ = data_rank(mesh)
    meter = SmoothedValue()
    for v in range(index + 1):
        meter.update(float(10 * index + v), n=2)
    meter.synchronize_between_processes(mesh)
    conf = ConfusionMatrix(3)
    conf.update(np.array([0, 1, 2, 255]), np.array([index % 3, 1, 0, 1]))
    conf.reduce_from_all_processes(mesh)
    per = torch.arange(4, dtype=torch.float64) + 4 * index
    args = types.SimpleNamespace(train_data_path=shards, input_size=32,
                                 seed=0, num_workers=0)
    imgs, cls = next(iter(_common.wds_train_loader(args, 4, mesh)))
    return dict(
        count=meter.count, total=meter.total, mat=conf.mat.copy(),
        main=is_main_process(), tensor_rank=tensor_rank(mesh),
        data_rank=data_rank(mesh), rows=batch_slice(np.arange(8),
                                                    mesh).tolist(),
        mean=float(_common.mean_over_ranks(torch.tensor([float(index)]),
                                           mesh)[0]),
        real_rows=_common.real_rows_mean(per, 6, mesh),
        ones=float(all_reduce_sum([1.0], mesh)[0]),
        ones_all=float(all_reduce_sum([1.0])[0]),
        loader=(np.asarray(imgs).copy(), np.asarray(cls).copy()))
