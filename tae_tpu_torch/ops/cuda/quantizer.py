"""K14: codebook nearest-neighbour search (counterpart of
``tae_tpu/ops/pallas/quantizer.py::nearest_code_pallas``; source
``tae_tpu_torch/csrc/quantizer.cu``, its launch plans in
``csrc/quantizer.cuh``, mirrored by :func:`vq_plan` for bf16 and
:func:`vq_f32_plan` for fp32) and its plain version.

For latents z (M, V) and a codebook (K, V): ``argmin_k (|c_k|^2 - 2 z.c_k)``
in fp32 (the ``|z|^2`` term is constant per row) on the codebook rounded to
z's dtype, the lowest index among equal distances, as int64 ids (M,). The
kernel streams the codebook and never writes the (M, K) distances; the plain
version materializes them. In bf16 a block's rows of z stay in shared
memory where they fit beside the codebook ring and ride it otherwise;
where the row blocks are fewer than the SMs, the codebook is split into
ranges searched by separate blocks whose per-row bests are merged. fp32
runs on the CUDA cores (no TF32) in register tiles of 8 rows x 8 codes a
thread, with the same split at few rows.

The search returns ids and has no gradient: both versions run on detached
tensors under ``no_grad``, so a z that requires a gradient (training calls
this under the straight-through estimator) passes through unharmed.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tae_tpu_torch.ops.cuda import build

_FLOATS = (torch.float32, torch.bfloat16)

# The bf16 plan's constants, mirrored from csrc/quantizer.cuh
#: columns of a pipeline step (128 bytes of bf16: the swizzle's span)
COLS = 64
#: codes of a tile (the wgmma's N)
CODES = 128
#: ring slots: at least MIN_STAGES beside a resident z, as many as fit up
#: to MAX_STAGES
MIN_STAGES = 4
MAX_STAGES = 8
#: consumer warpgroups of 64 rows a block: two from PAIR_ROWS rows on, and
#: from 65 rows where 64-row blocks could not keep z resident
MAX_CONSUMERS = 2
PAIR_ROWS = 512
#: dynamic shared memory a block may take beside its static barriers
SMEM_LIMIT = 232448 - 1024


@dataclasses.dataclass(frozen=True)
class VqPlan:
    """K14's bf16 launch (``tae::vq::Plan``): ``rows`` of z a block (64 a
    consumer warpgroup), ``codes`` a tile, ``stages`` ring slots, z
    ``resident`` in shared memory or riding the ring, grid (``blocks``,
    ``splits``) with ``per`` code tiles a range, ``smem`` bytes of dynamic
    shared memory a block."""
    rows: int
    consumers: int
    codes: int
    stages: int
    resident: int
    blocks: int
    splits: int
    per: int
    smem: int


def slot_bytes(rows: int, codes: int, resident: bool) -> int:
    """One ring slot: the codebook slab, z's slab when it rides the ring,
    the tile's norms, in whole 1024-byte units."""
    raw = codes * COLS * 2 + (0 if resident else rows * COLS * 2) + codes * 4
    return -(-raw // 1024) * 1024


def smem_bytes(rows: int, codes: int, stages: int, v: int,
               resident: bool) -> int:
    """z's resident slabs, ``stages`` ring slots, and 1024 bytes to align
    the base."""
    z = -(-v // COLS) * rows * COLS * 2 if resident else 0
    return z + stages * slot_bytes(rows, codes, resident) + 1024


def vq_plan(m: int, v: int, k: int, sms: int) -> VqPlan | None:
    """The plan ``tae::vq::plan`` computes for (M, V) latents against K
    codes on a card of ``sms`` SMs, or None where the kernel does not take
    the shape: two consumer warpgroups (128 rows) from PAIR_ROWS rows on,
    and from 65 rows where 64-row blocks would not keep z resident, else
    one; the codebook split into ranges where the blocks are fewer than
    the SMs (``sms // blocks`` of them, at most one a tile, none empty);
    z resident where it fits beside MIN_STAGES slots, the ring as many
    slots as then fit, up to MAX_STAGES."""
    if m < 1 or k < 1 or v < 8 or v % 8 or sms < 1:
        return None
    z64 = smem_bytes(64, CODES, MIN_STAGES, v, True) <= SMEM_LIMIT
    consumers = MAX_CONSUMERS if m > 64 and (m >= PAIR_ROWS or not z64) else 1
    rows = 64 * consumers
    blocks = -(-m // rows)
    tiles = -(-k // CODES)
    splits = max(1, min(tiles, sms // blocks)) if blocks < sms else 1
    per = -(-tiles // splits)
    resident = smem_bytes(rows, CODES, MIN_STAGES, v, True) <= SMEM_LIMIT
    room = SMEM_LIMIT - smem_bytes(rows, CODES, 0, v, resident)
    stages = min(MAX_STAGES, room // slot_bytes(rows, CODES, resident))
    if stages < 2:
        return None
    return VqPlan(rows, consumers, CODES, stages, int(resident), blocks,
                  -(-tiles // per), per,
                  smem_bytes(rows, CODES, stages, v, resident))


# The fp32 plan's constants, mirrored from csrc/quantizer.cuh (vq::f32)
#: rows of z a block; codes of a narrow and of a wide tile (16 x 16
#: threads, each 8 rows x 8 or 16 codes)
F32_ROWS = 128
F32_CODES = 128
F32_WIDE_CODES = 256
#: columns of a ring slot, and a slot's row of floats
F32_CHUNK = 32
F32_LD = F32_CHUNK + 4
#: ring slots, at least and at most
F32_MIN_STAGES = 2
F32_MAX_STAGES = 4


@dataclasses.dataclass(frozen=True)
class VqF32Plan:
    """K14's fp32 launch (``tae::vq::f32::Plan``): ``rows`` of z a block,
    ``codes`` a tile, ``chunk`` columns a ring slot, ``stages`` slots, z
    ``resident`` in shared memory or riding the ring, grid (``blocks``,
    ``splits``) with ``per`` code tiles a range, ``smem`` bytes of dynamic
    shared memory a block."""
    rows: int
    codes: int
    chunk: int
    stages: int
    resident: int
    blocks: int
    splits: int
    per: int
    smem: int


def f32_smem_bytes(v: int, codes: int, stages: int, resident: bool) -> int:
    """Resident z (its rows rounded up to whole chunks, plus 4 floats),
    ``stages`` ring slots (the codebook's chunk of ``codes`` rows, and z's
    where it rides), and the (distance, index) pairs of a block's two row
    halves."""
    ldz = -(-v // F32_CHUNK) * F32_CHUNK + 4
    slot = 4 * (codes + (0 if resident else F32_ROWS)) * F32_LD
    return ((4 * F32_ROWS * ldz if resident else 0) + stages * slot
            + 8 * 2 * F32_ROWS)


def vq_f32_plan(m: int, v: int, k: int, sms: int) -> VqF32Plan | None:
    """The plan ``tae::vq::f32::plan`` computes for (M, V) fp32 latents
    against K codes on a card of ``sms`` SMs, or None where the kernel does
    not take the shape (V a multiple of 4): 128-row blocks; 256-code tiles
    where the row blocks times such tiles are at least the SMs, else
    128-code tiles; the codebook split as in :func:`vq_plan`; z resident
    where it fits beside F32_MIN_STAGES slots, the ring as many slots as
    then fit, up to F32_MAX_STAGES."""
    if m < 1 or k < 1 or v < 4 or v % 4 or sms < 1:
        return None
    blocks = -(-m // F32_ROWS)
    codes = F32_WIDE_CODES if blocks * -(-k // F32_WIDE_CODES) >= sms else F32_CODES
    tiles = -(-k // codes)
    splits = max(1, min(tiles, sms // blocks)) if blocks < sms else 1
    per = -(-tiles // splits)
    resident = f32_smem_bytes(v, codes, F32_MIN_STAGES, True) <= SMEM_LIMIT
    slot = (f32_smem_bytes(v, codes, 1, resident)
            - f32_smem_bytes(v, codes, 0, resident))
    stages = min(F32_MAX_STAGES,
                 (SMEM_LIMIT - f32_smem_bytes(v, codes, 0, resident)) // slot)
    if stages < F32_MIN_STAGES:
        return None
    return VqF32Plan(F32_ROWS, codes, F32_CHUNK, stages, int(resident),
                     blocks, -(-tiles // per), per,
                     f32_smem_bytes(v, codes, stages, resident))


def vq_plan_of_library(m: int, v: int, k: int, sms: int) -> VqPlan | None:
    """The built library's plan: what ``chip_smoke.py`` holds
    :func:`vq_plan` against. Needs the card's build."""
    out = (ctypes.c_int * 10)()
    build.check(build.library().tae_nearest_code_plan(m, v, k, sms, out),
                "tae_nearest_code_plan")
    return VqPlan(*out[1:]) if out[0] else None


def vq_f32_plan_of_library(m: int, v: int, k: int, sms: int
                           ) -> VqF32Plan | None:
    """The built library's fp32 plan (``tae_nearest_code_f32_plan``). Needs
    the card's build."""
    out = (ctypes.c_int * 10)()
    build.check(build.library().tae_nearest_code_f32_plan(m, v, k, sms, out),
                "tae_nearest_code_f32_plan")
    return VqF32Plan(*out[1:]) if out[0] else None


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if z.dtype == torch.bfloat16:
        plan = vq_plan(m, v, k, sms)
        splits, kp = plan.splits, -(-k // plan.codes) * plan.codes
    else:
        splits, kp = vq_f32_plan(m, v, k, sms).splits, k
    norms = torch.empty((kp,), dtype=torch.float32, device=dev)
    ws = (torch.empty((2 * splits * m,), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    rc = build.library().tae_nearest_code_fwd(
        z.data_ptr(), codebook.data_ptr(), norms.data_ptr(), out.data_ptr(),
        build.ptr(ws), m, v, k, build.dtype_code(z.dtype), sms, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tae_nearest_code_fwd")
    nearest_code.launches += 1
    return out


nearest_code.launches = 0
