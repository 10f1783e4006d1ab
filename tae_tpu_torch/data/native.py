"""ctypes binding of the native data pipeline, ``libtaedata.so``
(counterpart of ``tae_tpu/data/native.py``).

Fused JPEG decode (with DCT-domain downscaling where the crop allows) ->
crop -> PIL-style separable resample -> flip -> normalize -> CHW float32 (or
uint8), per image or batched over a C++ thread pool. The source is the
repository's ``native/taedata.cpp``, built at first use with
``native/build.sh``'s flags into the port's own build directory,
``tae_tpu_torch/_build/<source hash>/libtaedata.so``, under a file lock, as
``ops/cuda/build.py`` builds the kernels.

:func:`available` is False under ``TAE_TPU_NATIVE=0`` or where the build
cannot run (no ``g++``, no libjpeg header): the drivers then take the PIL
path of :mod:`tae_tpu_torch.data.transforms`, as the JAX package's drivers
do. Which decoder ran is printed by every driver (:func:`decoder_name`).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

from tae_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
NATIVE_DIR = PACKAGE_DIR.parent / "native"
SOURCE = NATIVE_DIR / "taedata.cpp"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIB_NAME = "libtaedata.so"
# native/build.sh's flags; its second source, maskapi.cpp, needs no libjpeg
# and is built into a library of its own (data/mask_native.py), so the mask
# decoders build where libjpeg's header is missing
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared",
             "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

BILINEAR = 0
BICUBIC = 1


class NativeBuildError(RuntimeError):
    """g++ is missing or a native source did not compile (no libjpeg, say)."""


def _lib_path(build_root: pathlib.Path, source: pathlib.Path = SOURCE,
              lib_name: str = LIB_NAME, libs: tuple = LIBS) -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    h.update(source.read_bytes())
    return build_root / h.hexdigest()[:16] / lib_name


def build_library(build_root: pathlib.Path = BUILD_ROOT,
                  source: pathlib.Path = SOURCE, lib_name: str = LIB_NAME,
                  libs: tuple = LIBS) -> pathlib.Path:
    """Compile ``source`` (``native/taedata.cpp`` by default) with
    ``native/build.sh``'s flags unless a build of the same source exists
    under ``build_root``; returns the library's path. A file lock keeps two
    processes from building at once; the library is renamed into place
    whole."""
    lib = _lib_path(build_root, source, lib_name, libs)
    if lib.is_file():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found")
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.is_file():
            return lib
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            out = pathlib.Path(tmp) / lib_name
            proc = subprocess.run([cxx, *CXX_FLAGS, str(source), *libs, "-o",
                                   str(out)], capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise NativeBuildError(f"g++ failed ({proc.returncode}):\n"
                                       f"{proc.stderr[-4000:]}")
            os.replace(out, lib)
    return lib


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tae_jpeg_info.restype = ctypes.c_int
    lib.tae_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.tae_decode_to_tensor.restype = ctypes.c_int
    lib.tae_decode_to_tensor.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.tae_decode_batch.restype = ctypes.c_int
    lib.tae_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.tae_decode_batch_u8.restype = ctypes.c_int
    lib.tae_decode_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.cache
def _library(build_root: pathlib.Path):
    """The loaded library, built on first call; None where it cannot be
    built (the reason is printed once)."""
    try:
        return _typed(ctypes.CDLL(str(build_library(build_root))))
    except (NativeBuildError, OSError, subprocess.TimeoutExpired) as e:
        print(f"native decoder unavailable: {e}", flush=True)
        return None


def _load():
    if os.environ.get("TAE_TPU_NATIVE", "1") == "0":
        return None
    return _library(BUILD_ROOT)


def available() -> bool:
    return _load() is not None


def decoder_name() -> str:
    """The JPEG decoder the drivers run: ``"native"`` or ``"pil"``."""
    return "native" if available() else "pil"


def _fvec(vals) -> ctypes.Array:
    return (ctypes.c_float * len(vals))(*[float(v) for v in vals])


def jpeg_size(data: bytes) -> tuple[int, int]:
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.tae_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("not a decodable JPEG")
    return w.value, h.value


def decode_to_tensor(data: bytes, box: tuple[float, float, float, float],
                     out_size: int, filter: int = BICUBIC, hflip: bool = False,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD,
                     patch_size: int = 0) -> np.ndarray:
    """Fused decode+crop+resize+normalize -> (3, out, out) float32
    (``patch_size > 0``: pre-patchified (N, C·p²) extract_patches layout)."""
    lib = _load()
    out = np.empty(_out_shape(1, out_size, patch_size)[1:], np.float32)
    rc = lib.tae_decode_to_tensor(
        data, len(data), box[0], box[1], box[2], box[3], out_size, filter,
        _fvec(mean), _fvec(std), int(hflip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), patch_size)
    if rc != 0:
        raise ValueError(f"native decode failed (rc={rc})")
    return out


def center_crop(data: bytes, size: int, pad: int = 32, filter: int = BICUBIC,
                mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """Native analogue of the val transform: Resize(size+pad 'shorter side')
    + CenterCrop(size), expressed as one source-box resample."""
    w, h = jpeg_size(data)
    short = min(w, h)
    # after scaling shorter side to (size+pad), the center crop of `size`
    # maps back to a centered source box of side short*size/(size+pad)
    box_side = short * size / float(size + pad)
    cx, cy = w / 2.0, h / 2.0
    box = (cx - box_side / 2, cy - box_side / 2,
           cx + box_side / 2, cy + box_side / 2)
    return decode_to_tensor(data, box, size, filter=filter, mean=mean, std=std)


def _out_shape(n: int, out_size: int, patch_size: int) -> tuple[int, ...]:
    if patch_size:
        grid = out_size // patch_size
        return (n, grid * grid, 3 * patch_size * patch_size)
    return (n, 3, out_size, out_size)


def _compact(out: np.ndarray, status: np.ndarray, n: int, failed: int,
             skip_failed: bool):
    if not failed:
        return out, None
    ok = status == 0
    if not skip_failed:
        raise ValueError(f"native batch decode: {failed}/{n} images failed")
    return np.ascontiguousarray(out[ok]), ok


def decode_batch(datas: list[bytes], boxes: np.ndarray, hflips: np.ndarray,
                 out_size: int, filter: int = BICUBIC, threads: int = 0,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 patch_size: int = 0, skip_failed: bool = False):
    """Batched fused decode over the C++ thread pool.

    boxes: (N, 4) float32 source boxes; hflips: (N,) int32.
    threads=0 uses os.cpu_count(). ``patch_size > 0`` writes pre-patchified
    (N, C·p²) extract_patches layout — the device-side patch embedding
    becomes a pure matmul with zero relayout.

    ``skip_failed=False`` (default) raises if any image fails to decode and
    returns the (N, ...) array. ``skip_failed=True`` returns
    ``(decoded, keep_mask_or_None)`` with undecodable images dropped —
    keep_mask is None when nothing failed (one truncated JPEG must not
    abort a multi-hour tokenization run).
    """
    lib = _load()
    n = len(datas)
    arr_data = (ctypes.c_char_p * n)(*datas)
    arr_len = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    boxes = np.ascontiguousarray(boxes, np.float32)
    hflips = np.ascontiguousarray(hflips, np.int32)
    out = np.empty(_out_shape(n, out_size, patch_size), np.float32)
    status = np.zeros((n,), np.int32)
    threads = threads or (os.cpu_count() or 1)
    failed = lib.tae_decode_batch(
        arr_data, arr_len,
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hflips.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, out_size, filter, _fvec(mean), _fvec(std), threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), patch_size,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    compacted, mask = _compact(out, status, n, failed, skip_failed)
    return (compacted, mask) if skip_failed else compacted


def decode_batch_u8(datas: list[bytes], boxes: np.ndarray, hflips: np.ndarray,
                    out_size: int, filter: int = BICUBIC, threads: int = 0,
                    patch_size: int = 0, skip_failed: bool = False):
    """Batched fused decode to uint8 CHW (no normalization) — pairs with
    on-device normalization (tae_tpu_torch.data.transforms.device_normalize): 4x
    smaller host->device copies and PIL-exact uint8 rounding semantics.
    ``patch_size > 0`` emits extract_patches layout; ``skip_failed`` as in
    :func:`decode_batch`."""
    lib = _load()
    n = len(datas)
    arr_data = (ctypes.c_char_p * n)(*datas)
    arr_len = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    boxes = np.ascontiguousarray(boxes, np.float32)
    hflips = np.ascontiguousarray(hflips, np.int32)
    out = np.empty(_out_shape(n, out_size, patch_size), np.uint8)
    status = np.zeros((n,), np.int32)
    threads = threads or (os.cpu_count() or 1)
    failed = lib.tae_decode_batch_u8(
        arr_data, arr_len,
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hflips.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, out_size, filter, threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), patch_size,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    compacted, mask = _compact(out, status, n, failed, skip_failed)
    return (compacted, mask) if skip_failed else compacted
