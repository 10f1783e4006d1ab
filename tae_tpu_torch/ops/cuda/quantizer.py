"""K14: codebook nearest-neighbour search (counterpart of
``tae_tpu/ops/pallas/quantizer.py::nearest_code_pallas``; source
``tae_tpu_torch/csrc/quantizer.cu``) and its plain version.

For latents z (M, V) and a codebook (K, V): ``argmin_k (|c_k|^2 - 2 z.c_k)``
in fp32 (the ``|z|^2`` term is constant per row) on the codebook rounded to
z's dtype, the lowest index among equal distances, as int64 ids (M,). The kernel streams the codebook and
never writes the (M, K) distances; the plain version materializes them.
Latents too wide for a block's rows of z to stay in shared memory are tiled
over V as well (z's tile of each step rides the codebook's ring). Where the
row blocks are fewer than the SMs, the bf16 kernel splits the codebook into
ranges searched by separate blocks and merges their per-row bests
(:func:`code_splits`).

The search returns ids and has no gradient: both versions run on detached
tensors under ``no_grad``, so a z that requires a gradient (training calls
this under the straight-through estimator) passes through unharmed.
"""

from __future__ import annotations

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.int8_matmul import SMEM_LIMIT

_FLOATS = (torch.float32, torch.bfloat16)
#: bytes of the bf16 kernel's codebook ring (4 stages of 64 x 72 bf16)
RING_BYTES = 4 * 64 * 72 * 2


@torch.no_grad()
def nearest_code_reference(z: torch.Tensor, codebook: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version: z (..., V), codebook (K, V) -> int64 ids (...,). The
    codebook is rounded to z's dtype (what the kernel reads); fp32 distances
    ``|c|^2 - 2 z.c`` of the upcast operands, ``argmin`` (lowest index among
    equals)."""
    z32 = z.detach().float()
    cb32 = codebook.detach().to(z.dtype).float()
    dist = (cb32 * cb32).sum(dim=-1) - 2.0 * torch.matmul(z32, cb32.t())
    return torch.argmin(dist, dim=-1)


def resident(bm: int, v: int) -> bool:
    """Whether a block's ``bm`` rows of z fit shared memory beside the
    codebook ring (else the kernel tiles z over V)."""
    return bm * (-(-v // 64) * 64 + 8) * 2 + RING_BYTES <= SMEM_LIMIT


def code_splits(m: int, bm: int, k: int, sms: int) -> int:
    """Ranges of the codebook that separate blocks search (the bf16
    kernel's grid rows): 1 where the row blocks alone give every SM one,
    else enough for about two blocks an SM, at most one per 64-code tile."""
    blocks = -(-m // bm)
    if blocks >= sms:
        return 1
    return max(1, min(-(-k // 64), -(-2 * sms // blocks)))


def block_rows(m: int, v: int, sms: int) -> int:
    """Rows of z per block of the bf16 kernel: the largest of 128, 64, 32
    whose rows stay in shared memory and still give every SM a block; where
    none stays, the same choice among the tiled-over-V blocks (each fits);
    32 where no choice gives every SM a block."""
    fits = [bm for bm in (128, 64, 32) if resident(bm, v)] or [128, 64, 32]
    return next((bm for bm in fits if -(-m // bm) >= sms), fits[-1])


@torch.no_grad()
def nearest_code(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (M, V), codebook (K, V) -> int64 ids (M,). On CUDA: float32 or
    bfloat16 (the codebook is cast to z's dtype), V a multiple of 8
    (bfloat16) or 4 (float32), contiguous; anything else raises."""
    if z.ndim != 2 or codebook.ndim != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"z {tuple(z.shape)} and codebook "
                         f"{tuple(codebook.shape)} are not (M, V) and (K, V)")
    z, codebook = z.detach(), codebook.detach()
    if z.device.type == "cpu":
        return nearest_code_reference(z, codebook)
    if not z.is_cuda:
        raise ValueError(f"nearest_code takes CPU or CUDA tensors, not "
                         f"{z.device}")
    (m, v), k = z.shape, codebook.shape[0]
    step = 8 if z.dtype == torch.bfloat16 else 4
    if v % step or v < 4 or k < 1:
        raise ValueError(f"the nearest_code kernel takes V a multiple of "
                         f"{step} for {z.dtype}, and K >= 1; got V={v}, K={k}")
    dev = z.device
    build.check_operand("z", z, dev, _FLOATS)
    codebook = codebook.to(z.dtype)
    build.check_operand("codebook", codebook, dev, (z.dtype,), (k, v))
    out = torch.empty((m,), dtype=torch.int64, device=dev)
    if m == 0:
        return out
    norms = torch.empty((k,), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = block_rows(m, v, sms)
    splits = code_splits(m, rows, k, sms) if z.dtype == torch.bfloat16 else 1
    ws = (torch.empty((2 * splits * m,), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    rc = build.library().tae_nearest_code_fwd(
        z.data_ptr(), codebook.data_ptr(), norms.data_ptr(), out.data_ptr(),
        build.ptr(ws), m, v, k, build.dtype_code(z.dtype), rows, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_nearest_code_fwd")
    nearest_code.launches += 1
    return out


nearest_code.launches = 0
