"""K18: the AdamW update with moments in a reduced type, many tensors a
launch (source ``tae_tpu_torch/csrc/adamw.cu``).

Not a TPU kernel: the JAX package's ``adamw(moment_dtype=)``
(``tae_tpu/train/optim.py``) is elementwise work that XLA fuses into the
jitted step, and ``torch.optim.AdamW`` keeps its moments in the parameters'
dtype. :func:`adamw_update` updates a list of parameters in place: on CUDA
tensors one launch for each (device, parameter dtype, moment dtype), over a
table of the tensors that the host writes each step; on CPU tensors the
plain version, :func:`adamw_update_reference`, tensor by tensor.
:class:`UpdateTable` is one launch's table split into its host part (the
scalars written) and its device part (the launch), which a CUDA graph of
the train step holds while the host part runs before each replay.

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


class UpdateTable:
    """K18's table of one launch, kept for as long as the update it serves:
    rows ``(p, g, m, v)`` of one (device, parameter dtype, moment dtype)
    and the table on their device (on the CPU, a CPU tensor the plain
    version reads). The update runs in two parts, so that a CUDA graph can
    hold the second:

    - :meth:`write`, the host part: each row's fp32 scalars ``(decay, lr,
      c1, c2)`` written into a pinned host copy of the table, and the whole
      table copied to the device, on the current stream. It runs outside
      any graph (a pinned allocation is not allowed under capture), before
      each launch or replay; the pinned copy is rewritten only once the
      previous copy from it has run.
    - :meth:`launch`, the device part: K18 over the device table, one
      launch; on the CPU the plain version row by row, its scalars read from
      the table.

    The rows' addresses are fixed when the table is made, and a graph
    replays them: the gradients a graph captured stay where its table
    points. The device table, ``device_table`` where given (at least the
    live rows' length), must not come from a graph's pool: work earlier in the
    graph may reuse pool memory allocated during the capture, and would
    overwrite what the host part copies in before the replay. Each use
    copies the whole table in right before its launch on the same stream,
    so updates of one optimizer may share one."""

    def __init__(self, rows: list, *, b1: float, b2: float, eps: float,
                 device_table: torch.Tensor | None = None):
        # rows checked by update_tables, which makes the tables
        self.rows = rows
        self.b1, self.b2, self.eps = b1, b2, eps
        self.device = rows[0][0].device
        host, self.chunks = table([(*r, 1.0, 0.0, 1.0, 1.0) for r in rows])
        if self.device.type == "cuda" and self.chunks >= 2 ** 31:
            raise ValueError(f"adamw_update: {self.chunks} chunks exceed the "
                             "grid")
        # the rows with elements, in the kernel's table's order
        self.live = [i for i, r in enumerate(rows) if r[0].numel()]
        self._host = torch.from_numpy(host)
        if device_table is None:
            device_table = torch.empty(self._host.shape, dtype=torch.int64,
                                       device=self.device)
        self.table = device_table[:len(self.live)]
        self._pinned = self._copied = None

    def rebind(self, grads: list) -> None:
        """The same rows with the gradients ``grads`` (of the rows' shapes
        and dtypes): their addresses written into the table at the next
        :meth:`write`."""
        self.rows = [(p, g, m, v) for (p, _, m, v), g in zip(self.rows, grads)]
        ptrs = self._host.numpy()
        for j, i in enumerate(self.live):
            ptrs[j, 1] = self.rows[i][1].data_ptr()
        if self._pinned is not None:
            if self._copied is not None:
                self._copied.synchronize()
            self._pinned.copy_(self._host)

    def write(self, scalars) -> None:
        """The host part: ``scalars[i] = (decay, lr, c1, c2)`` of row ``i``
        (fp32 values, :func:`decay_factor`, :func:`bias_corrections`) into
        the table on the device."""
        values = np.asarray(scalars, np.float32).reshape(len(self.rows), 4)
        if self.device.type != "cuda":
            self._host.numpy().view(np.float32)[:, 12:16] = values[self.live]
            self.table.copy_(self._host)
            return
        if self._pinned is None:
            self._pinned = self._host.pin_memory()
        elif self._copied is not None:
            self._copied.synchronize()
        self._pinned.numpy().view(np.float32)[:, 12:16] = values[self.live]
        self.table.copy_(self._pinned, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()

    def launch(self) -> None:
        """The device part: K18 over the table (CUDA tensors), or its plain
        version tensor by tensor with the table's scalars (CPU tensors)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        if self.device.type != "cuda":
            scalars = self.table.numpy().view(np.float32)[:, 12:16]
            for j, i in enumerate(self.live):
                p, g, m, v = self.rows[i]
                decay, lr, c1, c2 = (float(x) for x in scalars[j])
                adamw_update_reference(p, g, m, v, lr=lr, decay=decay, b1=b1,
                                       b2=b2, eps=eps, c1=c1, c2=c2)
            return
        if not self.chunks:
            return
        p, m = self.rows[0][0], self.rows[0][2]
        rc = build.library().tae_adamw_update(
            self.table.data_ptr(), len(self.live), self.chunks,
            DTYPE_CODES[p.dtype], DTYPE_CODES[m.dtype], _f32(b1),
            _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2), _f32(eps),
            torch.cuda.current_stream(self.device).cuda_stream)
        build.check(rc, "tae_adamw_update")
        adamw_update.launches += 1


def update_tables(rows: list, *, b1: float, b2: float, eps: float,
                  tables: dict | None = None
                  ) -> list[tuple[list[int], UpdateTable]]:
    """``rows`` ``(p, g, m, v)`` split into the tables of their launches,
    one for each (device, parameter dtype, moment dtype), each with the
    indices of its rows in ``rows``. All on the CPU: one table, the plain
    version. All on CUDA devices: K18's. Anything else raises.

    ``tables``: the caller's device tables by launch, reused from one
    update to the next and made here where missing or short, never under
    a graph's capture (:class:`UpdateTable` says why): an update captured
    in a graph finds them made by an eager one."""
    if not all(r[0].device.type == "cpu" for r in rows) and not all(
            r[0].is_cuda for r in rows):
        raise ValueError("adamw_update takes all tensors on the CPU or all on "
                         "CUDA devices")
    groups: dict[tuple, list[int]] = {}
    for i, (p, g, m, v) in enumerate(rows):
        _check(p, g, m, v)
        key = ("cpu",) if p.device.type == "cpu" else (p.device, p.dtype,
                                                       m.dtype)
        groups.setdefault(key, []).append(i)
    out = []
    for key, idx in groups.items():
        dev = None
        if tables is not None and key != ("cpu",):
            key = (*key, b1, b2, eps)
            dev = tables.get(key)
            live = sum(rows[i][0].numel() > 0 for i in idx)
            if dev is None or len(dev) < live:
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        "K18's table is made outside a graph's capture: "
                        "run an eager update of these tensors first")
                dev = tables[key] = torch.empty(
                    (live, 8), dtype=torch.int64,
                    device=rows[idx[0]][0].device)
        out.append((idx, UpdateTable([rows[i] for i in idx], b1=b1, b2=b2,
                                     eps=eps, device_table=dev)))
    return out


def adamw_update(params, grads, exp_avgs, exp_avg_sqs, decays, lrs, c1s, c2s,
                 *, b1: float, b2: float, eps: float) -> None:
    """Update ``params`` and their moments in place: lists of tensors of one
    length, with the per-tensor fp32 scalars ``decays``
    (:func:`decay_factor`), ``lrs`` and bias corrections ``c1s`` / ``c2s``
    (:func:`bias_corrections`). All on the CPU: the plain version. All on
    CUDA devices: K18, one launch for each (device, parameter dtype, moment
    dtype), each over a table made for this call (:class:`UpdateTable`).
    Anything else raises."""
    rows = list(zip(params, grads, exp_avgs, exp_avg_sqs))
    scalars = list(zip(decays, lrs, c1s, c2s))
    for idx, tab in update_tables(rows, b1=b1, b2=b2, eps=eps):
        tab.write([scalars[i] for i in idx])
        tab.launch()


adamw_update.launches = 0
