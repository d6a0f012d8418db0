"""Native (C++) host runtime: bitstream finishing at memory speed.

Compiled on demand with g++ into a shared object next to the source and
loaded via ctypes (no pybind11 in this environment). Every entry point has
a numpy fallback in entropy.host, and the test suite pins them to each
other — the native path is a strict performance substitution.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bitpack.cpp")
_SO = os.path.join(_HERE, "_bitpack.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                # per-process temp name: concurrent first users (test
                # workers) must not write one file at once
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.jt_stuff_bytes.restype = ctypes.c_size_t
            lib.jt_stuff_bytes.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ]
            lib.jt_words_to_stuffed.restype = ctypes.c_size_t
            lib.jt_words_to_stuffed.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.jt_pack_codes.restype = ctypes.c_size_t
            lib.jt_pack_codes.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.jt_bmp_to_rgb.restype = None
            lib.jt_bmp_to_rgb.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def stuff_bytes(raw: np.ndarray) -> bytes:
    """0xFF -> 0xFF 00 stuffing of a contiguous uint8 array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(2 * raw.size + 1, dtype=np.uint8)
    n = lib.jt_stuff_bytes(raw.ctypes.data, raw.size, out.ctypes.data)
    return out[:n].tobytes()


def words_to_stuffed(words: np.ndarray, total_bits: int) -> bytes:
    """Packed MSB-aligned uint32 word stream -> stuffed entropy bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    nbytes = (int(total_bits) + 7) // 8
    out = np.empty(2 * nbytes + 4, dtype=np.uint8)
    n = lib.jt_words_to_stuffed(words.ctypes.data, int(total_bits), out.ctypes.data)
    return out[:n].tobytes()


def pack_codes(values: np.ndarray, nbits: np.ndarray, pad_ones: bool = True) -> bytes:
    """(value, bit-length) pairs -> stuffed byte stream (host packer)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    values = np.ascontiguousarray(values, dtype=np.uint32)
    nbits = np.ascontiguousarray(nbits, dtype=np.uint8)
    total = int(nbits.sum(dtype=np.int64))
    out = np.empty(2 * (total // 8 + 2), dtype=np.uint8)
    n = lib.jt_pack_codes(
        values.ctypes.data, nbits.ctypes.data, values.size,
        1 if pad_ones else 0, out.ctypes.data,
    )
    return out[:n].tobytes()


def bmp_to_rgb(px: np.ndarray, height: int, width: int, row_stride: int,
               top_down: bool) -> np.ndarray:
    """Native BMP pixel pass: px is the raw (padded, possibly bottom-up
    BGR) pixel section as uint8; returns RGB [H, W, 3]."""
    lib = _load()
    assert lib is not None
    px = np.ascontiguousarray(px, dtype=np.uint8)
    out = np.empty((height, width, 3), np.uint8)
    lib.jt_bmp_to_rgb(
        px.ctypes.data, height, width, row_stride, int(top_down),
        out.ctypes.data,
    )
    return out
