"""ctypes binding of the native COCO mask algorithms, ``native/maskapi.cpp``
(counterpart of ``tae_tpu/data/mask_native.py``).

A second, independent implementation of the maskApi polygon scan
conversion and both RLE forms, written as scalar C++: the tests hold the
numpy decoders of :mod:`tae_tpu_torch.data.coco_seg` to it bit for bit on
randomized polygons and RLEs (pycocotools is not a dependency). It is not
on the data path: the numpy decoders are the one production implementation.

The JAX package links maskapi.cpp into ``libtaedata.so`` beside the JPEG
decoder, with ``-ljpeg``. maskapi.cpp needs no libjpeg, so the port builds
it alone, at first use, with ``native/build.sh``'s flags
(``-ffp-contract=off`` included: the scan conversion's rounding must not
be contracted into FMAs) into ``tae_tpu_torch/_build/<source hash>/
libtaemask.so``, and it builds where libjpeg's header is missing.
:func:`available` is False under ``TAE_TPU_NATIVE=0`` or where the build
cannot run (no ``g++``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess

import numpy as np

from tae_tpu_torch.data import native

SOURCE = native.NATIVE_DIR / "maskapi.cpp"
BUILD_ROOT = native.BUILD_ROOT
LIB_NAME = "libtaemask.so"


def build_library(build_root: pathlib.Path = BUILD_ROOT) -> pathlib.Path:
    return native.build_library(build_root, SOURCE, LIB_NAME, libs=())


@functools.cache
def _library(build_root: pathlib.Path):
    """The loaded library, built on first call; None where it cannot be
    built (the reason is printed once)."""
    try:
        lib = ctypes.CDLL(str(build_library(build_root)))
    except (native.NativeBuildError, OSError, subprocess.TimeoutExpired) as e:
        print(f"native mask decoders unavailable: {e}", flush=True)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tae_mask_rle_decode.restype = None
    lib.tae_mask_rle_decode.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u8p]
    lib.tae_mask_rle_frstring.restype = ctypes.c_int
    lib.tae_mask_rle_frstring.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p]
    lib.tae_mask_frpoly.restype = None
    lib.tae_mask_frpoly.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u8p]
    return lib


def _load():
    if os.environ.get("TAE_TPU_NATIVE", "1") == "0":
        return None
    return _library(BUILD_ROOT)


def available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native mask decoders are not built (no g++, "
                           "or TAE_TPU_NATIVE=0); guard calls with "
                           "mask_native.available()")
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_rle_counts(counts: list[int], height: int, width: int) -> np.ndarray:
    lib = _lib()
    c = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((height, width), np.uint8)
    lib.tae_mask_rle_decode(c.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                            len(c), height, width, _u8(out))
    return out


def decode_compressed_rle(counts: str, height: int, width: int) -> np.ndarray:
    lib = _lib()
    out = np.zeros((height, width), np.uint8)
    if lib.tae_mask_rle_frstring(counts.encode(), height, width, _u8(out)):
        raise ValueError("truncated compressed RLE string")
    return out


def rasterize_polygons(polys: list[list[float]], height: int, width: int
                       ) -> np.ndarray:
    """Union of per-ring maskApi scan conversions, as
    :func:`tae_tpu_torch.data.coco_seg.rasterize_polygons` (pycocotools'
    ``frPyObjects`` + decode + any)."""
    lib = _lib()
    mask = np.zeros((height, width), np.uint8)
    part = np.zeros((height, width), np.uint8)
    for poly in polys:
        if len(poly) >= 6:
            xy = np.ascontiguousarray(poly, np.float64)
            lib.tae_mask_frpoly(xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                len(xy) // 2, height, width, _u8(part))
            mask |= part
    return mask
