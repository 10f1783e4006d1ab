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
# C entry points: (argument types, return type). The launchers return a
# cudaError_t, 0 on success.
SIGNATURES = {
    # x, weight, bias, y, rows, cols, eps, x dtype, weight dtype, stream
    "tae_layer_norm_fwd": ((_VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _VP), _I),
    # qkv, out, batch, tokens, heads, head dim, scale, serving, dtype, stream
    "tae_packed_attention_fwd": ((_VP, _VP, _I, _I, _I, _I, _F, _I, _I, _VP),
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
    # x, gamma, beta, q, s, rows, cols, eps, x dtype, gamma dtype, stream
    "tae_ln_quant_fwd": ((_VP, _VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _VP), _I),
    # x, sx, w, sw, bias, residual, out, m, n, k, out dtype, bias dtype,
    # ln rows per block (0: no ln_out), gamma, beta, ln dtype, eps, nq, ns,
    # stream
    "tae_int8_matmul_fwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                             _I, _I, _VP, _VP, _I, _F, _VP, _VP, _VP), _I),
    # xq, sx, w1, sw1, b1, w2, sw2, b2, residual, out, m, d, hdim, block_h,
    # rows per block, out dtype, bias dtype, gamma, beta, ln dtype, eps, nq,
    # ns, workspace of the hidden groups, hidden groups, stream
    "tae_int8_mlp_fwd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                          _I, _I, _I, _I, _I, _I, _VP, _VP, _I, _F, _VP, _VP,
                          _VP, _I, _VP), _I),
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


def sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_root: pathlib.Path = BUILD_ROOT) -> pathlib.Path:
    """Compile the kernels unless a build of the same sources exists;
    returns the library's path. ``build.log`` beside it keeps ptxas's
    register and shared-memory report."""
    out_dir = build_root / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    units = [p for p in sources() if p.suffix == ".cu"]
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_dir = pathlib.Path(tmp)
        objects = [tmp_dir / (p.stem + ".o") for p in units]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o",
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


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with _build_lock:
        lib = ctypes.CDLL(str(build_library()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


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


def ptr(t) -> int | None:
    """The device address of an optional tensor (None: a null pointer)."""
    return None if t is None else t.data_ptr()
