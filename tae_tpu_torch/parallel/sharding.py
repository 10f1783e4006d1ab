"""Parameter and batch placement on the mesh (counterpart of
``tae_tpu/parallel/sharding.py``).

The JAX package places each parameter by path rules (``param_shardings``)
and lets GSPMD insert the collectives. The port first splits each block
over ``tensor`` (:mod:`tae_tpu_torch.parallel.tensor`: qkv / fc1 by output
rows, proj / fc2 by input columns, as the JAX rules cut them) and then
hands the model to FSDP2 (:func:`shard_model`): ``fully_shard`` on every
transformer block, on each head, then on the root, over the 2-D mesh
``mesh["data", "fsdp"]``. Parameters, gradients and AdamW moments are
sharded over ``fsdp`` and replicated over ``data`` (HSDP); a block's
parameters are all-gathered just before its forward and its backward and
freed after, and its gradients reduce-scattered (and all-reduced over
``data``) as its backward ends. The gradient is the mean over all ``data``
× ``fsdp`` ranks: with each rank's loss the mean of its rows, the mean of
the global batch, as the JAX package's global-batch loss gives it. With
``fsdp = 1`` this is plain data parallelism.

Placement differs from the JAX rules, numerics do not. FSDP2 shards every
parameter on dim 0 (the output rows of a ``Linear``, of its ``tensor``
share where the block is split), where a rule of the JAX package names
another dim or replicates a 1-D leaf, and it pads a dim 0 that ``fsdp``
does not divide where the JAX rules fall back to replication
(``_axis_ok``): a unit of FSDP2 has no per-parameter replication. The
``tensor`` split cuts qkv by heads and falls back to a whole block where
``tensor`` does not divide the heads or the hidden width (the JAX rule
tests 3·D). :func:`param_placements` gives each parameter's shard.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

#: the modules taken as their own FSDP2 unit after the blocks: each model's
#: output projections
HEADS = ("dict_proj", "decoder_pred", "head", "aux_head")
#: methods that callers invoke on the root instead of ``forward``
#: (``Tokenizer``, the drivers' eval and frozen-encoder paths)
ROOT_METHODS = ("forward_encoder", "forward_decoder", "forward_features")


def axis_sizes(mesh) -> dict[str, int]:
    """``{"data": d, "fsdp": f, "tensor": t}`` of a ``DeviceMesh`` built by
    :func:`~tae_tpu_torch.parallel.mesh.make_mesh`, of such a dict, or of
    None (a world of 1)."""
    if mesh is None:
        return {"data": 1, "fsdp": 1, "tensor": 1}
    if isinstance(mesh, dict):
        return {"data": 1, "fsdp": 1, "tensor": 1, **mesh}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Placement:
    """One parameter on the mesh: its global ``shape``; ``tensor_dim``, the
    dim split over ``tensor`` (None: whole on every tensor rank);
    ``local_shape``, the shard each rank stores (``tensor_dim`` cut into
    ``tensor`` pieces, then dim 0 into ``fsdp`` pieces of ceil(dim 0 /
    fsdp) rows, the last ones padded); ``padded`` where ``fsdp`` does not
    divide that dim 0 (the JAX rules replicate such a dim)."""
    shape: tuple[int, ...]
    local_shape: tuple[int, ...]
    padded: bool
    tensor_dim: int | None = None

    def local_bytes(self, element_size: int) -> int:
        return math.prod(self.local_shape) * element_size


def param_placements(model: nn.Module, mesh) -> dict[str, Placement]:
    """Each parameter's placement under :func:`shard_model` on ``mesh`` (a
    ``DeviceMesh``, a dict of axis sizes or None), computed from shapes
    alone: an unsplit model on the ``meta`` device will do."""
    from tae_tpu_torch.parallel import tensor as tp

    sizes = axis_sizes(mesh)
    fsdp, tensor = sizes["fsdp"], sizes["tensor"]
    split_dims = {}
    if tensor > 1:
        for name, block in tp.blocks(model):
            if tp.splits(block, tensor):
                for leaf, dim in tp.SPLIT_DIMS.items():
                    split_dims[f"{name}.{leaf}" if name else leaf] = dim
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if not shape:
            out[name] = Placement(shape, shape, False)
            continue
        dim = split_dims.get(name)
        cut = list(shape)
        if dim is not None:
            cut[dim] //= tensor
        rows = -(-cut[0] // fsdp)
        out[name] = Placement(shape, (rows, *cut[1:]), cut[0] % fsdp != 0,
                              dim)
    return out


def is_sharded(model: nn.Module) -> bool:
    """Whether ``model`` is placed on a mesh: FSDP2's or the tensor split's
    ``DTensor`` parameters (:func:`shard_model`,
    :func:`tae_tpu_torch.parallel.tensor.split_model_`)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in model.parameters())


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Place ``model`` on ``mesh``, in place, and return it: each block
    split over ``mesh["tensor"]`` where it splits
    (:func:`tae_tpu_torch.parallel.tensor.split_model_`), then FSDP2's
    ``fully_shard`` on each block of every stack, on each head
    (:data:`HEADS`), then on the root, over ``mesh["data", "fsdp"]``; the
    root's other entry points (:data:`ROOT_METHODS`) gather its parameters
    as ``forward`` does. ``mesh`` None (a world of 1 without a process
    group) leaves the model as it is."""
    if mesh is None:
        return model
    from tae_tpu_torch.parallel.tensor import blocks, split_model_

    split_model_(model, mesh)
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    hsdp = mesh["data", "fsdp"]
    for _, block in blocks(model):
        fully_shard(block, mesh=hsdp)
    for name in HEADS:
        head = getattr(model, name, None)
        if isinstance(head, nn.Module) and any(True for _ in head.parameters()):
            fully_shard(head, mesh=hsdp)
    fully_shard(model, mesh=hsdp)
    for method in ROOT_METHODS:
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    return model


def data_rank(mesh) -> tuple[int, int]:
    """``(index, count)`` of this rank over the (data, fsdp) ranks: its
    share of a global batch, which its tensor peers share."""
    if mesh is None:
        return 0, 1
    sizes = axis_sizes(mesh)
    index = (mesh.get_local_rank("data") * sizes["fsdp"]
             + mesh.get_local_rank("fsdp"))
    return index, sizes["data"] * sizes["fsdp"]


def batch_slice(x, mesh):
    """This rank's rows of a global batch ``x`` (a tensor or an array, the
    leading axis over (data, fsdp) in rank order): the counterpart of
    ``batch_sharding``. The leading axis must divide evenly."""
    index, count = data_rank(mesh)
    if count == 1:
        return x
    if x.shape[0] % count:
        raise ValueError(f"global batch {x.shape[0]} does not divide over "
                         f"{count} data x fsdp ranks")
    per = x.shape[0] // count
    return x[index * per:(index + 1) * per]


def constrain_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` unchanged. The JAX function pins an activation to batch-only
    sharding so that GSPMD's partitioner does not rematerialize it across
    a dim-mixing reshape; in PyTorch every activation is rank-local (each
    rank holds its own rows and FSDP2 moves only parameters and gradients),
    so there is nothing to pin."""
    del mesh
    return x
