"""K18: the AdamW update with moments in a reduced type, many tensors a
launch (source ``tae_tpu_torch/csrc/adamw.cu``).

Not a TPU kernel: the JAX package's ``adamw(moment_dtype=)``
(``tae_tpu/train/optim.py``) is elementwise work that XLA fuses into the
jitted step, and ``torch.optim.AdamW`` keeps its moments in the parameters'
dtype. :func:`adamw_update` updates a list of parameters in place: on CUDA
tensors one launch for each (device, parameter dtype, moment dtype), over a
table of the tensors that the host writes each step; on CPU tensors the
plain version, :func:`adamw_update_reference`, tensor by tensor.

The scalars are fp32 values the host computes once per tensor
(:func:`bias_corrections`, :func:`decay_factor`) and both versions read, so
the kernel and its plain version agree bit for bit. The plain version's
scalars are 0-dim tensors on the data's device: a Python number as the
divisor of a CUDA tensor is turned into a product by its reciprocal, which
is not the kernel's division.
"""

from __future__ import annotations

import numpy as np
import torch

from tae_tpu_torch.ops.cuda import build

#: elements a block of the kernel updates (csrc/adamw.cu's kChunk)
CHUNK = 8192
#: the kernel's dtype codes: parameters and gradients fp32 or bf16, moments
#: also fp16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PARAM_DTYPES = (torch.float32, torch.bfloat16)
MOMENT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _f32(x) -> float:
    return float(np.float32(x))


def bias_corrections(b1: float, b2: float, step: int) -> tuple[float, float]:
    """``(1 - b1 ** step, 1 - b2 ** step)`` in fp32, as the JAX package
    forms them."""
    one, t = np.float32(1.0), np.float32(step)
    return (float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t))


def decay_factor(lr: float, weight_decay: float) -> float:
    """``1 - lr * weight_decay`` in fp32 (1 where nothing decays)."""
    if not weight_decay:
        return 1.0
    return float(np.float32(1.0) - np.float32(lr) * np.float32(weight_decay))


@torch.no_grad()
def adamw_update_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                           v: torch.Tensor, *, lr: float, decay: float,
                           b1: float, b2: float, eps: float, c1: float,
                           c2: float) -> None:
    """The plain version: one tensor's update in place, in fp32, in the
    kernel's order of operations."""
    def s(x):
        return torch.tensor(_f32(x), dtype=torch.float32, device=p.device)

    p32, g32 = p.float(), g.float()
    if decay != 1.0:
        p32 = p32 * s(decay)
    m32 = m.float() * s(b1) + g32 * s(1.0 - b1)
    v32 = v.float() * s(b2) + (g32 * g32) * s(1.0 - b2)
    step = (s(lr) * (m32 / s(c1))) / (torch.sqrt(v32 / s(c2)) + s(eps))
    p.copy_(p32 - step)
    m.copy_(m32)
    v.copy_(v32)


def _check(p, g, m, v) -> None:
    if p.dtype not in PARAM_DTYPES or g.dtype != p.dtype:
        raise TypeError(f"adamw_update takes fp32 / bf16 parameters with "
                        f"gradients of their dtype, got {p.dtype} / {g.dtype}")
    if m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype:
        raise TypeError(f"moments must be one of {MOMENT_DTYPES}, got "
                        f"{m.dtype} / {v.dtype}")
    for name, t in (("gradient", g), ("exp_avg", m), ("exp_avg_sq", v)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not "
                             f"match the parameter {tuple(p.shape)} on "
                             f"{p.device}")
    for t in (p, g, m, v):
        if not t.is_contiguous():
            raise ValueError("adamw_update takes contiguous tensors")


def table(rows: list) -> tuple[np.ndarray, int]:
    """The kernel's table (csrc/adamw.cu's Entry, eight int64 a row) of
    ``rows`` ``(p, g, m, v, decay, lr, c1, c2)``, empty tensors left out,
    and the grid: the chunks of all tensors."""
    rows = [r for r in rows if r[0].numel()]
    out = np.zeros((len(rows), 8), np.int64)
    scalars = out.view(np.float32)
    chunk0 = 0
    for i, (p, g, m, v, decay, lr, c1, c2) in enumerate(rows):
        n = p.numel()
        out[i, :6] = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                      n, chunk0)
        scalars[i, 12:16] = (decay, lr, c1, c2)
        chunk0 += -(-n // CHUNK)
    return out, chunk0


def adamw_update(params, grads, exp_avgs, exp_avg_sqs, decays, lrs, c1s, c2s,
                 *, b1: float, b2: float, eps: float) -> None:
    """Update ``params`` and their moments in place: lists of tensors of one
    length, with the per-tensor fp32 scalars ``decays``
    (:func:`decay_factor`), ``lrs`` and bias corrections ``c1s`` / ``c2s``
    (:func:`bias_corrections`). All on the CPU: the plain version. All on
    CUDA devices: K18, one launch for each (device, parameter dtype, moment
    dtype). Anything else raises."""
    rows = list(zip(params, grads, exp_avgs, exp_avg_sqs, decays, lrs, c1s,
                    c2s))
    for p, g, m, v, *_ in rows:
        _check(p, g, m, v)
    if all(r[0].device.type == "cpu" for r in rows):
        for p, g, m, v, decay, lr, c1, c2 in rows:
            adamw_update_reference(p, g, m, v, lr=lr, decay=decay, b1=b1,
                                   b2=b2, eps=eps, c1=c1, c2=c2)
        return
    if not all(r[0].is_cuda for r in rows):
        raise ValueError("adamw_update takes all tensors on the CPU or all on "
                         "CUDA devices")
    groups: dict[tuple, list] = {}
    for r in rows:
        groups.setdefault((r[0].device, r[0].dtype, r[2].dtype), []).append(r)
    for (device, p_dtype, m_dtype), group in groups.items():
        host, chunks = table(group)
        if not chunks:
            continue
        if chunks >= 2 ** 31:
            raise ValueError(f"adamw_update: {chunks} chunks exceed the grid")
        dev = torch.from_numpy(host).pin_memory().to(device, non_blocking=True)
        rc = build.library().tae_adamw_update(
            dev.data_ptr(), len(host), chunks, DTYPE_CODES[p_dtype],
            DTYPE_CODES[m_dtype], _f32(b1), _f32(1.0 - b1), _f32(b2),
            _f32(1.0 - b2), _f32(eps),
            torch.cuda.current_stream(device).cuda_stream)
        build.check(rc, "tae_adamw_update")
        adamw_update.launches += 1


adamw_update.launches = 0
