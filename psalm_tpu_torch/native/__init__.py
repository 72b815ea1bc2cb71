"""ctypes bindings for the native host library (``rle.cpp``): the COCO RLE
codec and the batched mask IoU.

Counterpart of ``psalm_tpu/native/__init__.py``. The library is built with
``make`` at first use into ``build/psalm_tpu_torch/`` at the root of the
checkout, named by a hash of the source (an edited source is rebuilt), and
written under a temporary name then renamed, so concurrent first users see
all of it or nothing. A failed build raises: there is no silent fallback.
The numpy codec in ``psalm_tpu_torch/data/coco_rle.py`` is the reference
the tests hold this library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "psalm_tpu_torch"
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256((_DIR / "rle.cpp").read_bytes()
                            + (_DIR / "Makefile").read_bytes()).hexdigest()
    return BUILD_DIR / f"librle_{digest[:16]}.so"


def build() -> Path:
    """Compile rle.cpp unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["make", "-C", str(_DIR), "-s", f"OUT={tmp}"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {out.name} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64 = ctypes.c_int64
    lib.rle_encode.restype = i64
    lib.rle_encode.argtypes = [u8p, i64, i64, u32p]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [u32p, i64, u8p, i64, i64]
    lib.rle_to_string.restype = i64
    lib.rle_to_string.argtypes = [u32p, i64, ctypes.c_char_p]
    lib.rle_from_string.restype = i64
    lib.rle_from_string.argtypes = [ctypes.c_char_p, i64, u32p]
    lib.mask_iou_matrix.restype = None
    lib.mask_iou_matrix.argtypes = [u8p, i64, u8p, i64, i64, u8p,
                                    ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def encode(mask: np.ndarray):
    lib = get_lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    counts = np.empty(h * w + 1, np.uint32)
    n = lib.rle_encode(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       h, w, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    counts = counts[:n]
    buf = ctypes.create_string_buffer(int(n) * 8)
    m = lib.rle_to_string(counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                          n, buf)
    return {"size": [int(h), int(w)], "counts": buf.raw[:m]}


def decode(rle) -> np.ndarray:
    lib = get_lib()
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        s = counts.encode() if isinstance(counts, str) else counts
        out_counts = np.empty(h * w + 1, np.uint32)
        n = lib.rle_from_string(s, len(s), out_counts.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)))
        counts = out_counts[:n]
    else:
        counts = np.asarray(counts, np.uint32)
        n = len(counts)
    total = int(np.asarray(counts, np.uint64).sum())
    if total > h * w:
        raise ValueError(
            f"corrupt RLE: run total {total} exceeds size {h}x{w}")
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode(counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    return out


def mask_iou_matrix(a: np.ndarray, b: np.ndarray,
                    iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    lib = get_lib()
    P = len(a)
    G = len(b)
    if P == 0 or G == 0:
        return np.zeros((P, G))
    a = np.ascontiguousarray(a.reshape(P, -1), np.uint8)
    b = np.ascontiguousarray(b.reshape(G, -1), np.uint8)
    crowd = np.ascontiguousarray(
        iscrowd if iscrowd is not None else np.zeros(G), np.uint8)
    out = np.empty((P, G), np.float64)
    lib.mask_iou_matrix(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), P,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), G, a.shape[1],
        crowd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
