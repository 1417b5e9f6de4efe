"""ctypes binding to the native (C++) host runtime, with build-on-demand.

`native/gemma_native.cpp` implements the load-time hot path — parallel
block-dequant and GGUF→device-layout repack — as a C-ABI shared library
(this framework's counterpart to the reference's C++ runtime substrate:
thread_pool.cpp + the ggml loader, SURVEY.md §2). This module compiles it
with g++ on first use (cached next to the source, keyed on source mtime)
and exposes numpy-level wrappers. Everything degrades gracefully to the
pure-numpy codecs (quant/numpy_ref.py) when a compiler is unavailable or
GEMMA_TPU_NATIVE=0.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..gguf.constants import GGMLType

_SRC = Path(__file__).resolve().parents[2] / "native" / "gemma_native.cpp"
_LIB_PATH = _SRC.with_suffix(".so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB_PATH
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-o", str(_LIB_PATH), str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return _LIB_PATH
    except (OSError, subprocess.SubprocessError):
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GEMMA_TPU_NATIVE", "1") == "0" or not _SRC.exists():
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.gt_dequant.argtypes = [ctypes.c_int, u8p, i64, i64, f32p]
        lib.gt_dequant.restype = ctypes.c_int
        lib.gt_repack_q4_0.argtypes = [u8p, i64, i64, u8p, u16p]
        lib.gt_repack_q8_0.argtypes = [u8p, i64, i64, i8p, u16p]
        lib.gt_repack_q4_k.argtypes = [u8p, i64, i64, u8p, i8p]
        lib.gt_repack_q6_k.argtypes = [u8p, i64, i64, u8p, u8p, i8p, u16p]
        for fn in (lib.gt_repack_q4_0, lib.gt_repack_q8_0, lib.gt_repack_q4_k,
                   lib.gt_repack_q6_k):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _raw_u8(raw) -> np.ndarray:
    a = np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) else raw
    return np.ascontiguousarray(a.view(np.uint8).reshape(-1))


_NATIVE_DEQUANT_TYPES = {
    GGMLType.F32, GGMLType.F16, GGMLType.BF16,
    GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K,
}


def dequantize(raw, t: GGMLType, shape: tuple[int, ...]) -> np.ndarray | None:
    """Parallel native dequant to f32; None -> caller uses numpy_ref."""
    lib = _load()
    if lib is None or t not in _NATIVE_DEQUANT_TYPES:
        return None
    shape = tuple(int(s) for s in shape)
    cols = shape[-1] if shape else 1
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    buf = _raw_u8(raw)
    out = np.empty(rows * cols, np.float32)
    rc = lib.gt_dequant(
        int(t), _ptr(buf, ctypes.c_uint8), rows, cols, _ptr(out, ctypes.c_float)
    )
    if rc != 0:
        return None
    return out.reshape(shape)


def _wide(sc_u16: np.ndarray) -> np.ndarray:
    """f16-bit scales from the C++ repacker -> bf16 storage (qtensor layout
    v4 stores scales as bf16; see quant/qtensor.py docstring)."""
    from ..quant.qtensor import SCALE_DTYPE

    return np.ascontiguousarray(sc_u16.view(np.float16).astype(SCALE_DTYPE))


def _as_bf16(u16: np.ndarray) -> np.ndarray:
    """Raw bf16 bits from the C++ repacker (hi/lo superscale arrays) ->
    bf16 view; the C++ side already did the exact hi/lo split."""
    from ..quant.qtensor import SCALE_DTYPE

    return u16.view(SCALE_DTYPE)


def repack(raw, t: GGMLType, shape: tuple[int, int]) -> dict[str, np.ndarray] | None:
    """GGUF payload -> K-major device arrays (qtensor.py layout); None on
    unsupported type / no native lib."""
    lib = _load()
    if lib is None:
        return None
    N, K = int(shape[0]), int(shape[1])
    buf = _raw_u8(raw)
    u8 = ctypes.c_uint8
    if t == GGMLType.Q4_0:
        qs = np.empty((K // 2, N), np.uint8)
        sc = np.empty((K // 32, N), np.uint16)
        lib.gt_repack_q4_0(_ptr(buf, u8), N, K, _ptr(qs, u8), _ptr(sc, ctypes.c_uint16))
        return {"qs": qs, "scales": _wide(sc)}
    if t == GGMLType.Q8_0:
        qs = np.empty((K, N), np.int8)
        sc = np.empty((K // 32, N), np.uint16)
        lib.gt_repack_q8_0(_ptr(buf, u8), N, K, _ptr(qs, ctypes.c_int8), _ptr(sc, ctypes.c_uint16))
        return {"qs": qs, "scales": _wide(sc)}
    if t == GGMLType.Q4_K:
        qs = np.empty((K // 2, N), np.uint8)
        meta = np.empty((3 * K // 32, N), np.int8)
        lib.gt_repack_q4_k(
            _ptr(buf, u8), N, K, _ptr(qs, u8), _ptr(meta, ctypes.c_int8)
        )
        return {"qs": qs, "meta": meta}
    if t == GGMLType.Q6_K:
        ql = np.empty((K // 2, N), np.uint8)
        qh = np.empty((K // 4, N), np.uint8)
        sc8 = np.empty((K // 16, N), np.int8)
        d = np.empty((K // 64, N), np.uint16)
        lib.gt_repack_q6_k(
            _ptr(buf, u8), N, K, _ptr(ql, u8), _ptr(qh, u8),
            _ptr(sc8, ctypes.c_int8), _ptr(d, ctypes.c_uint16),
        )
        return {"ql": ql, "qh": qh, "sc8": sc8, "d": _as_bf16(d)}
    return None
