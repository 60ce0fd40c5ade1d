"""ctypes bindings for the native kernels.

Without g++ the entry points return None and the caller decodes with numpy,
as the JAX package does. Unlike the JAX package, a build or a call that
fails where g++ is present raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from speaksense_tpu_torch.native.build import build

_lib = None
_tried = False
_lock = threading.Lock()


def _load():
    global _lib, _tried
    with _lock:
        if not _tried:
            path = build()
            if path is not None:
                lib = ctypes.CDLL(str(path))
                lib.ggml_dequantize.restype = ctypes.c_int
                lib.ggml_dequantize.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                                ctypes.c_int64, ctypes.c_int]
                lib.pcm16_to_f32.restype = None
                lib.pcm16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
                _lib = lib
            _tried = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def _record_bytes(ttype: int, n: int) -> int:
    per_block = {2: 18, 3: 20, 6: 22, 7: 24, 8: 34}
    if ttype == 1:
        return 2 * n
    if ttype not in per_block:
        raise ValueError(f"unsupported ggml tensor type {ttype}")
    if n % 32:
        raise ValueError(f"quantized tensor size {n} not a multiple of 32")
    return n // 32 * per_block[ttype]


def dequantize_native(data: bytes, ttype: int, n: int,
                      nthreads: int | None = None) -> np.ndarray | None:
    """Decode n elements of ggml type ttype with C++ threads; None without
    g++. F32 (ttype 0) needs no decode."""
    lib = _load()
    if lib is None:
        return None
    if ttype == 0:
        return np.frombuffer(data, "<f4", count=n).copy()
    src = np.frombuffer(data, np.uint8)
    need = _record_bytes(ttype, n)
    if src.size < need:
        raise ValueError(f"{src.size} bytes hold fewer than the {need} of {n} elements")
    out = np.empty((n,), np.float32)
    nthreads = nthreads or min(os.cpu_count() or 1, 16)
    rc = lib.ggml_dequantize(ttype, src.ctypes.data_as(ctypes.c_void_p),
                             out.ctypes.data_as(ctypes.c_void_p), n, nthreads)
    if rc != 0:
        raise RuntimeError(f"ggml_dequantize failed on type {ttype} (rc={rc})")
    return out


def pcm16_to_f32_native(data: bytes) -> np.ndarray | None:
    """s16le PCM -> f32 scaled by 1/32768; None without g++."""
    lib = _load()
    if lib is None:
        return None
    n = len(data) // 2
    src = np.frombuffer(data, np.int16, count=n)
    out = np.empty((n,), np.float32)
    lib.pcm16_to_f32(src.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), n)
    return out
