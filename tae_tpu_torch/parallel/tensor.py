"""The ``tensor`` axis of the mesh: the Megatron split of each transformer
block (counterpart of the ``tensor`` rules of
``tae_tpu/parallel/sharding.py``).

The JAX package shards the qkv / fc1 output dim and the proj / fc2 input
dim over ``tensor`` and lets GSPMD insert the collectives around its
kernels. The port splits each block itself, so that every rank runs its
own kernels on its own heads:

* ``attn.qkv`` and ``mlp.fc1`` are column-parallel: rank r holds the output
  rows of its share (weight rows and bias). ``attn.qkv`` is cut by heads,
  not in contiguous rows as the JAX rule cuts it: rank r holds the q, k and
  v rows of heads [r·H/t, (r+1)·H/t), so its local qkv output is packed
  (B, N, 3·D/t), the layout the attention kernels read, and
  ``attn.num_heads`` becomes the local count H/t.
* ``attn.proj`` and ``mlp.fc2`` are row-parallel: rank r holds the weight
  columns of its share; each rank's partial product is summed over
  ``tensor`` (in fp32, each partial rounded once to the compute dtype by
  its GEMM, the sum rounded once after the bias) before the bias and the
  residual.
* The input of qkv and of fc1 crosses into the split region by an identity
  whose backward sums the gradient over ``tensor``; the output sum's
  backward is the identity. Everything outside the split (the LayerNorms,
  embeddings, heads, the biases of proj and fc2) is whole on every tensor
  rank, and tensor peers compute it alike.

A split weight is a ``DTensor`` on ``mesh["tensor"]`` (``Shard(0)`` for a
column-parallel layer, ``Shard(1)`` for a row-parallel weight), which
FSDP2 composes with its own sharding over ``mesh["data", "fsdp"]``
(:func:`tae_tpu_torch.parallel.sharding.shard_model`); the layers read
``to_local()``. A block whose head count or hidden width ``tensor`` does
not divide stays whole on every tensor rank (the counterpart of the JAX
rule's fallback to replication). Only float blocks split: the int8 and int4
serving artifacts stay whole.

Checkpoints keep the reference's layout: :func:`to_reference` undoes the
head grouping of a gathered qkv tensor and :func:`to_ranks` applies it to a
full tensor before it is placed.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

#: the parameters of a split block's qkv, whose rows are grouped by rank
QKV = ("attn.qkv.weight", "attn.qkv.bias")
#: a split block's parameters that are cut, and the dim each is cut on
SPLIT_DIMS = {"attn.qkv.weight": 0, "attn.qkv.bias": 0,
              "mlp.fc1.weight": 0, "mlp.fc1.bias": 0,
              "attn.proj.weight": 1, "mlp.fc2.weight": 1}


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (split over ``tensor``, sharded by
    FSDP2, or both); any other tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The fp32 sum over ``group`` of ``t``, in a fresh contiguous buffer."""
    s = t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(s, group=group)
    return s


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the tensor peers."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group).to(grad.dtype), None


class _Reduce(torch.autograd.Function):
    """The fp32 sum over the tensor peers forward; identity backward."""

    @staticmethod
    def forward(ctx, part, group):
        ctx.dtype = part.dtype
        return _sum_f32(part, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


@dataclasses.dataclass(frozen=True, eq=False)
class TensorSplit:
    """A block's share on the ``tensor`` axis: ``size`` ranks of
    ``group``, this one ``rank``; ``heads``, the block's head count before
    the split."""
    group: object
    size: int
    rank: int
    heads: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel layer."""
        return _Enter.apply(x, self.group)

    def row_linear(self, y: torch.Tensor, lin: nn.Module) -> torch.Tensor:
        """``lin(y)`` of a row-parallel layer on this rank's columns ``y``:
        the partial product, its fp32 sum over the peers, then the bias
        (in the compute dtype, as the whole layer adds it), rounded once."""
        part = F.linear(y, local_shard(lin.weight).to(y.dtype))
        out = _Reduce.apply(part, self.group)
        if lin.bias is not None:
            out = out + lin.bias.to(y.dtype)
        return out.to(y.dtype)


def splits(block: nn.Module, tensor: int) -> bool:
    """Whether ``block`` splits over ``tensor`` ranks: its four linears are
    float and ``tensor`` divides its head count and its MLP hidden width.
    Computed from shapes alone (a block on the ``meta`` device will do)."""
    from tae_tpu_torch.nn.vit import Linear

    a, m = block.attn, block.mlp
    if not all(isinstance(lin, Linear)
               for lin in (a.qkv, a.proj, m.fc1, m.fc2)):
        return False
    heads = a.num_heads if a.tensor is None else a.tensor.heads
    return heads % tensor == 0 and m.fc1.weight.shape[0] % tensor == 0


def blocks(model: nn.Module) -> list[tuple[str, nn.Module]]:
    """``(name, block)`` of every transformer block of every stack."""
    from tae_tpu_torch.nn.vit import Block

    return [(n, m) for n, m in model.named_modules() if isinstance(m, Block)]


def regroup(full: torch.Tensor, tensor: int, to_ranks: bool) -> torch.Tensor:
    """A qkv weight or bias (rows first) between the reference's rows
    [q | k | v] and the rows grouped by rank, [q_0 k_0 v_0 | q_1 k_1 v_1 |
    ...] (``to_ranks``), and back."""
    c = full.shape[0] // 3 // tensor
    rest = tuple(full.shape[1:])
    shape = (3, tensor, c, *rest) if to_ranks else (tensor, 3, c, *rest)
    return full.reshape(shape).transpose(0, 1).reshape(full.shape)


def _place(lin: nn.Module, attr: str, full: torch.Tensor, dim: int,
           mesh, rank: int, size: int) -> None:
    from torch.distributed.tensor import DTensor, Shard

    old = getattr(lin, attr)
    shard = full.detach().chunk(size, dim)[rank].contiguous()
    setattr(lin, attr, nn.Parameter(
        DTensor.from_local(shard, mesh, [Shard(dim)], run_check=False),
        requires_grad=old.requires_grad))


def split_model_(model: nn.Module, mesh) -> nn.Module:
    """Split every block of ``model`` that :func:`splits` over
    ``mesh["tensor"]``, in place, and return it. A mesh whose ``tensor``
    axis is 1 (or None) leaves the model as it is; a block already split is
    left alone."""
    from tae_tpu_torch.parallel.sharding import axis_sizes

    size = axis_sizes(mesh)["tensor"]
    if size == 1:
        return model
    sub = mesh["tensor"]
    group, rank = sub.get_group(), sub.get_local_rank()
    for _, block in blocks(model):
        a, m = block.attn, block.mlp
        if a.tensor is not None or not splits(block, size):
            continue
        split = TensorSplit(group, size, rank, a.num_heads)
        place = dict(mesh=sub, rank=rank, size=size)
        _place(a.qkv, "weight", regroup(a.qkv.weight, size, True), 0, **place)
        if a.qkv.bias is not None:
            _place(a.qkv, "bias", regroup(a.qkv.bias, size, True), 0, **place)
        _place(m.fc1, "weight", m.fc1.weight, 0, **place)
        _place(m.fc1, "bias", m.fc1.bias, 0, **place)
        _place(a.proj, "weight", a.proj.weight, 1, **place)
        _place(m.fc2, "weight", m.fc2.weight, 1, **place)
        a.num_heads //= size
        a.tensor = m.tensor = split
    return model


def qkv_names(model: nn.Module) -> dict[str, int]:
    """Parameter name -> ``tensor`` size of each split block's qkv weight
    and bias (the names of ``model.named_parameters()``)."""
    out = {}
    for name, block in blocks(model):
        if block.attn.tensor is not None:
            for leaf in QKV:
                out[f"{name}.{leaf}" if name else leaf] = block.attn.tensor.size
    return out


def _convert(state: dict, model: nn.Module, to_ranks: bool) -> dict:
    names = qkv_names(model)
    out = dict(state)
    for name, size in names.items():
        v = out.get(name)
        if isinstance(v, dict):     # an optimizer's state of the parameter
            out[name] = {k: regroup(x, size, to_ranks)
                         if isinstance(x, torch.Tensor) and x.ndim else x
                         for k, x in v.items()}
        elif isinstance(v, torch.Tensor):
            out[name] = regroup(v, size, to_ranks)
    return out


def to_reference(state: dict, model: nn.Module) -> dict:
    """``state`` (full tensors, or per-parameter optimizer state, by
    parameter name) gathered from split ``model``, with each split qkv
    back in the reference's rows. A new dict; other entries are kept."""
    return _convert(state, model, False)


def to_ranks(state: dict, model: nn.Module) -> dict:
    """The inverse of :func:`to_reference`: full tensors in the reference's
    layout, the split qkv rows grouped by rank, ready to be placed."""
    return _convert(state, model, True)
