"""The device mesh (counterpart of ``tae_tpu/parallel/mesh.py``).

The JAX package names one mesh with axes ``data`` (pure data parallelism),
``fsdp`` (parameters and optimizer state sharded, ZeRO-style) and
``tensor`` (Megatron-style splits inside attention and the MLP), and GSPMD
inserts the collectives. The port keeps the names and maps them onto
``torch.distributed``: a ``DeviceMesh`` over one process per device, the
Megatron split of each block (:mod:`tae_tpu_torch.parallel.tensor`) over
``tensor``, FSDP2 (:mod:`tae_tpu_torch.parallel.sharding`) over the
``data`` × ``fsdp`` half. ``tensor`` is the innermost axis, so tensor
peers are adjacent ranks (the JAX package's device order).

Tensor peers hold the same rows of every batch: a sum over ranks counts
each ``data`` × ``fsdp`` rank once (:func:`all_reduce_sum`).

A process with no process group is a world of 1: the drivers build no
mesh there and run as they always have. :func:`initialize_distributed`
joins the processes that ``torchrun`` (or the caller) starts: NCCL on CUDA,
gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor")


def world_size() -> int:
    """Processes in the default group, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    """Rank-0 gating for checkpoint writes and logging (reference
    util/misc.py:203-209): true on rank 0, or where there is no process
    group."""
    return rank() == 0


def mesh_sizes(n: int, data: int = -1, fsdp: int = 1,
               tensor: int = 1) -> tuple[int, int, int]:
    """``(data, fsdp, tensor)`` for ``n`` devices, with the JAX
    ``make_mesh``'s errors: ``data=-1`` absorbs the devices the other axes
    leave, and the product must be ``n``."""
    if data == -1:
        if n % (fsdp * tensor):
            raise ValueError(
                f"{n} devices not divisible by fsdp*tensor={fsdp * tensor}")
        data = n // (fsdp * tensor)
    if data * fsdp * tensor != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n} devices")
    return data, fsdp, tensor


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1,
              device_type: str | None = None):
    """A ``("data", "fsdp", "tensor")`` ``DeviceMesh`` over the default
    process group's ranks, in rank order (``tensor``, then ``fsdp``, the
    chattier axes, innermost). ``device_type`` defaults to ``cuda`` under
    NCCL, else ``cpu``. The counts are checked as the JAX ``make_mesh``
    checks them before any group is needed; building the mesh needs
    :func:`initialize_distributed` first."""
    sizes = mesh_sizes(world_size(), data, fsdp, tensor)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "tae_tpu_torch.parallel.initialize_distributed() "
                           "first (a world of 1 runs without a mesh)")
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, sizes, mesh_dim_names=AXES)


def tensor_rank(mesh=None) -> int:
    """This rank's index on the ``tensor`` axis of ``mesh`` (0 without
    one): tensor rank 0 writes what tensor peers would write alike."""
    if mesh is None or isinstance(mesh, dict):
        return 0
    return mesh.get_local_rank("tensor")


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           local_rank: int | None = None,
                           backend: str | None = None,
                           device_type: str | None = None) -> torch.device:
    """Join the process group (the reference's
    ``dist.init_process_group("nccl")``, util/misc.py:212-242) and return
    this rank's device. The arguments default to torchrun's environment:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``env://``). ``device_type`` ``cuda`` (the default
    where a card is present) takes NCCL and ``cuda:LOCAL_RANK``; ``cpu``
    takes gloo. Idempotent: a second call returns the device."""
    env = os.environ
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    device = (torch.device("cuda", local_rank) if device_type == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    kw = {}
    if init_method is None and "MASTER_ADDR" not in env:
        raise RuntimeError("initialize_distributed needs an init_method or "
                           "torchrun's MASTER_ADDR / MASTER_PORT")
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        rank = int(env["RANK"])
    if device.type == "cuda":
        kw["device_id"] = device
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(minutes=30), **kw)
    return device


def all_reduce_sum(values, mesh=None) -> np.ndarray:
    """The sum over the ``data`` × ``fsdp`` ranks of ``mesh`` (every
    process without one) of a float64 array: tensor peers hold the same
    rows, so only tensor rank 0's array is counted.
    The array itself in a world of 1; through the group's backend (a CUDA
    tensor under NCCL)."""
    arr = np.asarray(values, dtype=np.float64)
    if world_size() == 1:
        return arr
    if tensor_rank(mesh):
        arr = np.zeros_like(arr)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(arr.copy()).to(device)
    dist.all_reduce(t)
    return t.cpu().numpy()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
