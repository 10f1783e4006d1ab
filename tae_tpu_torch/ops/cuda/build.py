"""Build and load the hand-written CUDA kernels.

All sources in ``tae_tpu_torch/csrc/`` compile with ``nvcc`` for ``sm_90a``
(one ``nvcc -c`` per ``.cu``, all started together) and link into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use and is cached under ``tae_tpu_torch/_build/``, keyed by a hash of
the sources and the flags, so a fresh checkout builds everything on its
first kernel launch and a changed source rebuilds.

A missing ``nvcc`` or a failed compile raises; nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIB_NAME = "libtae_kernels.so"
# The toolkit's standard install location, consulted after PATH and
# CUDA_HOME / CUDA_PATH.
DEFAULT_CUDA_HOME = pathlib.Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_build_lock = threading.Lock()

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
# C entry points: (argument types, return type). The launchers return a
# cudaError_t, 0 on success.
SIGNATURES = {
    # x, weight, bias, y, rows, cols, eps, x dtype, weight dtype, stream
    "tae_layer_norm_fwd": ((_VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _VP), _I),
    # x, weight, bias, y, mean, rstd, rows, cols, eps, x dtype, weight dtype,
    # stream
    "tae_layer_norm_fwd_stats": ((_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _F, _I,
                                  _I, _VP), _I),
    # x, weight, mean, rstd, dy, dx, dw, db, partial sums, rows, cols, row
    # chunks, rows per chunk, x dtype, weight dtype, stream
    "tae_layer_norm_bwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                            _I, _I, _I, _I, _VP), _I),
    # qkv, out, batch, tokens, heads, head dim, scale, serving, dtype, stream
    "tae_packed_attention_fwd": ((_VP, _VP, _I, _I, _I, _I, _F, _I, _I, _VP),
                                 _I),
    # qkv, out, lse, batch, tokens, heads, head dim, scale, dtype, stream
    "tae_packed_attention_fwd_lse": ((_VP, _VP, _VP, _I, _I, _I, _I, _F, _I,
                                      _VP), _I),
    # qkv, o, lse, do, dqkv, batch, tokens, heads, head dim, scale, dtype,
    # stream
    "tae_packed_attention_bwd": ((_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F,
                                  _I, _VP), _I),
    # q, k, v, out, lse (or null), (image, head, row) strides of q, k, v and
    # out, batch, tokens, heads, head dim, scale, dtype, stream
    "tae_flash_attention_fwd": ((_VP, _VP, _VP, _VP, _VP, _LLP, _I, _I, _I, _I,
                                 _F, _I, _VP), _I),
    # q, k, v, o, lse, do, dq, dk, dv, strides of those eight but lse, batch,
    # tokens, heads, head dim, scale, dtype, stream
    "tae_flash_attention_bwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                 _LLP, _I, _I, _I, _I, _F, _I, _VP), _I),
    # int8 qkv, scales, out, batch, tokens, heads, head dim, scale block,
    # scale, stream
    "tae_qkv_i8_attention_fwd": ((_VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP),
                                 _I),
    # qkv, out, batch, tokens, heads, head dim, scale, serving, dtype, stream
    "tae_wide_attention_fwd": ((_VP, _VP, _I, _I, _I, _I, _F, _I, _I, _VP), _I),
    # qkv, int8 out, scales, batch (2d: rows), tokens, heads, head dim, scale,
    # dtype, stream
    "tae_packed_attention_q8_fwd": ((_VP, _VP, _VP, _I, _I, _I, _I, _F, _I,
                                     _VP), _I),
    "tae_wide_attention_q8_fwd": ((_VP, _VP, _VP, _I, _I, _I, _I, _F, _I,
                                   _VP), _I),
    "tae_wide_attention_q8_2d_fwd": ((_VP, _VP, _VP, _I, _I, _I, _I, _F, _I,
                                      _VP), _I),
    # tokens, heads, head dim, int[6] out: K7 / K8's plan on the forward body
    "tae_attention_q8_plan": ((_I, _I, _I, ctypes.POINTER(_I)), _I),
    # tokens, head dim, int[4] out: the fp32 attention backward's launch
    "tae_attention_bwd_f32_plan": ((_I, _I, ctypes.POINTER(_I)), _I),
    # the same for K7 / K8 in float32 on the tiled fp32 forward body
    "tae_attention_q8_f32_plan": ((_I, _I, _I, ctypes.POINTER(_I)), _I),
    # tokens, heads, head dim, int8 output (0 / 1), int[7] out: the flat-row
    # body's plan (K6, K9)
    "tae_rows_attention_plan": ((_I, _I, _I, _I, ctypes.POINTER(_I)), _I),
    # the same for the flat-row body's float32 form
    "tae_rows_attention_f32_plan": ((_I, _I, _I, _I, ctypes.POINTER(_I)), _I),
    # x, gamma, beta, q, s, rows, cols, eps, x dtype, gamma dtype, stream
    "tae_ln_quant_fwd": ((_VP, _VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _VP), _I),
    # rows, cols, int[4] out: K3's plan
    "tae_ln_quant_plan": ((_I, _I, ctypes.POINTER(_I)), _I),
    # rows, cols, int[4] out: K1's plan
    "tae_layer_norm_fwd_plan": ((_I, _I, ctypes.POINTER(_I)), _I),
    # rows, cols, int[8] out: K11's plan
    "tae_layer_norm_bwd_plan": ((_I, _I, ctypes.POINTER(_I)), _I),
    # x, sx, w, sw, bias, residual, out, m, n, k, out dtype, bias dtype,
    # ln_out (0 / 1), gamma, beta, ln dtype, eps, nq, ns, tile shape, K
    # splits, int32 workspace (or null), stream
    "tae_int8_matmul_fwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                             _I, _I, _VP, _VP, _I, _F, _VP, _VP, _I, _I, _VP,
                             _VP), _I),
    # x, x dtype (2: int8 codes), sx, w, sw, bias, bias dtype, residual, out,
    # out dtype, q8_out scales (or null), q8_out block (0: none), m, n, k,
    # tile shape, K splits, int32 workspace (or null), int8 workspace of a
    # float x (or null), stream
    "tae_int8_matmul_rows_fwd": ((_VP, _I, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I,
                                  _VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP),
                                 _I),
    # xq, sx, w1, sw1, b1, w2, sw2, b2, residual, out, m, d, hdim, block_h,
    # out dtype, bias dtype, gamma, beta, ln dtype, eps, nq, ns, hidden codes,
    # hidden scales, fp32 workspace of the hidden groups, hidden groups, fc1
    # tile shape, fc2 tile shape, stream
    "tae_int8_mlp_fwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                          _I, _I, _I, _I, _I, _VP, _VP, _I, _F, _VP, _VP, _VP,
                          _VP, _VP, _I, _I, _I, _VP), _I),
    # x, sx, packed w, group scales, bias, residual, out, m, n, k, group,
    # out dtype, bias dtype, tile shape, stream
    "tae_int4_matmul_fwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                             _I, _I, _I, _VP), _I),
    # xq, sx, packed w1, s1, b1, packed w2, s2, b2, residual, out, m, d, hdim,
    # fc1 group, fc2 group, out dtype, bias dtype, hidden codes, hidden
    # scales, fp32 workspace of the hidden groups (or null), hidden groups,
    # fc1 tile shape, fc2 tile shape, stream
    "tae_int4_mlp_fwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                          _I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I,
                          _VP), _I),
    # z, codebook, norms workspace, ids, workspace of the codebook ranges (or
    # null), m, v, k, dtype, the card's SMs, codebook ranges, stream
    "tae_nearest_code_fwd": ((_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                              _VP), _I),
    # m, v, k, the card's SMs, int[11] out: K14's bf16 plan
    "tae_nearest_code_plan": ((_I, _I, _I, _I, ctypes.POINTER(_I)), _I),
    # m, v, k, the card's SMs, int[10] out: K14's fp32 plan
    "tae_nearest_code_f32_plan": ((_I, _I, _I, _I, ctypes.POINTER(_I)), _I),
    # table, tensors, chunks, parameter dtype, moment dtype, b1, 1 - b1, b2,
    # 1 - b2, eps, stream: K18's multi-tensor AdamW update
    "tae_adamw_update": ((_VP, _I, ctypes.c_longlong, _I, _I, _F, _F, _F, _F,
                          _F, _VP), _I),
    "tae_error_string": ((_I,), ctypes.c_char_p),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or the kernel sources did not compile."""


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME/bin, $CUDA_PATH/bin, then the
    toolkit's default location. Raises KernelBuildError if none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             str(DEFAULT_CUDA_HOME)]
    for home in homes:
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin, $CUDA_PATH/bin "
        f"and {DEFAULT_CUDA_HOME}/bin): the tae_tpu_torch CUDA kernels "
        "cannot be built, and CUDA tensors have no other path")


def sources(csrc_dir: pathlib.Path = CSRC_DIR) -> list[pathlib.Path]:
    return sorted(p for p in csrc_dir.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash(csrc_dir: pathlib.Path = CSRC_DIR) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(csrc_dir):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_root: pathlib.Path = BUILD_ROOT,
                  csrc_dir: pathlib.Path = CSRC_DIR) -> pathlib.Path:
    """Compile the kernels of ``csrc_dir`` unless a build of the same
    sources exists; returns the library's path. ``build.log`` beside it
    keeps ptxas's register and shared-memory report."""
    out_dir = build_root / source_hash(csrc_dir)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    units = [p for p in sources(csrc_dir) if p.suffix == ".cu"]
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_dir = pathlib.Path(tmp)
        objects = [tmp_dir / (p.stem + ".o") for p in units]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(csrc_dir), "-c", str(src), "-o",
                 str(obj)] for src, obj in zip(units, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        log, failed = [], []
        for cmd, proc in zip(cmds, procs):
            try:
                out, _ = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                out += "\n(killed after 900 s)"
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-3]} ({proc.returncode}):\n{out[-4000:]}")
        tmp_lib = tmp_dir / LIB_NAME
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objects)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise KernelBuildError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp_lib, lib)
    return lib


def load(path: pathlib.Path) -> ctypes.CDLL:
    """A built kernel library, its C entry points typed (an entry that a
    library built from an older checkout lacks is left out)."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with _build_lock:
        path = build_library()
    return load(path)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().tae_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: cudaError {rc} ({msg})")


def dtype_code(dtype) -> int:
    """The kernels' dtype codes: 0 = float32, 1 = bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, not {dtype}")
    return codes[dtype]


def check_operand(name: str, t, device, dtypes, shape=None) -> None:
    """Raise unless tensor ``t`` is what a kernel can read through a raw
    pointer: on ``device``, of one of ``dtypes``, of ``shape`` (if given),
    contiguous and 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def needs_grad(*tensors) -> bool:
    """Whether autograd is recording and one of ``tensors`` takes part."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(entry: str, *tensors) -> None:
    """Raise if autograd would record through a forward-only kernel entry:
    its output carries no ``grad_fn``, so a backward pass would leave every
    parameter ahead of it without a gradient, silently."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{entry} is forward-only (a serving entry: no backward kernel "
            "exists for it) and was given a tensor that requires a gradient; "
            "call it under torch.no_grad() / inference_mode(), or train "
            "through the float path with serving=False")


def ptr(t) -> int | None:
    """The device address of an optional tensor (None: a null pointer)."""
    return None if t is None else t.data_ptr()


def int64_array(values):
    """A host array of int64 for an entry point that takes one by pointer."""
    return (ctypes.c_longlong * len(values))(*values)
