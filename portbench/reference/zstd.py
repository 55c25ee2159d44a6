"""zstd through ctypes, for the frozen reference: a copy of the port's
`entropy/zstd_backend.py` that loads the system's libzstd and nothing else.

The encoder compresses at level 18 (5..21 for alpha). Compressed bytes
depend on the library's version, so the benchmark compares streams by what
they decompress to, never by their compressed bytes.
"""
from __future__ import annotations

import ctypes
import ctypes.util

_lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")


_lib.ZSTD_compressBound.restype = ctypes.c_size_t
_lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
_lib.ZSTD_compress.restype = ctypes.c_size_t
_lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                               ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
_lib.ZSTD_decompress.restype = ctypes.c_size_t
_lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                 ctypes.c_void_p, ctypes.c_size_t]
_lib.ZSTD_isError.restype = ctypes.c_uint
_lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
_lib.ZSTD_versionNumber.restype = ctypes.c_uint
try:
    _lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    _lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                              ctypes.c_size_t]
    _HAS_FCS = True
except AttributeError:   # very old zstd
    _HAS_FCS = False

VERSION = int(_lib.ZSTD_versionNumber())

import threading as _threading

import numpy as _np

_lib.ZSTD_createDCtx.restype = ctypes.c_void_p
_lib.ZSTD_decompressDCtx.restype = ctypes.c_size_t
_lib.ZSTD_decompressDCtx.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_size_t]
_TLS = _threading.local()


def _dctx():
    # one reused decompression context per thread: ZSTD_decompress
    # allocates+frees a DCtx internally on every call (~20us each, and the
    # planner makes ~28 calls per image)
    d = getattr(_TLS, "dctx", None)
    if d is None:
        d = _TLS.dctx = ctypes.c_void_p(_lib.ZSTD_createDCtx())
    return d


_lib.ZSTD_createCCtx.restype = ctypes.c_void_p
_lib.ZSTD_compressCCtx.restype = ctypes.c_size_t
_lib.ZSTD_compressCCtx.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_int]


def _cctx():
    # one reused compression context per thread: one-shot ZSTD_compress
    # allocates+frees the multi-MB level-18 workspace on EVERY call, and
    # the encoder makes ~28 calls per image. ZSTD_compressCCtx fully
    # re-initializes per call, so the output bytes are identical to
    # ZSTD_compress (golden byte-exactness tests cover this).
    c = getattr(_TLS, "cctx", None)
    if c is None:
        c = _TLS.cctx = ctypes.c_void_p(_lib.ZSTD_createCCtx())
    return c


def compress(data: bytes, level: int = 18, dst_capacity: int | None = None) -> bytes:
    """ZSTD_compress semantics. dst_capacity mirrors the reference's
    explicit output buffer sizes (it never uses compressBound); results
    don't depend on it unless too small, in which case zstd errors like
    the reference would."""
    if dst_capacity is None:
        dst_capacity = int(_lib.ZSTD_compressBound(len(data)))
    out = _np.empty(dst_capacity, _np.uint8)    # no zero-fill (hot path)
    n = _lib.ZSTD_compressCCtx(_cctx(), out.ctypes.data, dst_capacity,
                               data, len(data), level)
    if _lib.ZSTD_isError(n):
        raise RuntimeError(f"ZSTD_compress failed (capacity {dst_capacity})")
    return out[:n].tobytes()


def decompress(data: bytes, expected_size: int) -> bytes:
    """ZSTD_decompress with exact expected-size check (DecompressData,
    YAIK_API.cpp:505-521)."""
    return decompress_arr(data, expected_size).tobytes()


def decompress_arr(data: bytes, expected_size: int):
    """decompress returning a u8 numpy array (no bytes-copy; the planner's
    hot path feeds np.frombuffer anyway)."""
    out = _np.empty(expected_size if expected_size else 1, _np.uint8)
    n = _lib.ZSTD_decompressDCtx(_dctx(), out.ctypes.data, expected_size,
                                 data, len(data))
    if _lib.ZSTD_isError(n) or n != expected_size:
        raise ValueError(f"zstd decompress: got {n}, expected {expected_size}")
    return out[:expected_size]


def frame_content_size(data: bytes) -> int | None:
    """Decoded size recorded in the zstd frame header, or None if unknown.
    (Single-shot ZSTD_compress always records it, so streams written by the
    reference or by us carry it.)"""
    if not _HAS_FCS or not data:
        return None
    n = int(_lib.ZSTD_getFrameContentSize(data, len(data)))
    if n >= 2 ** 63:   # ZSTD_CONTENTSIZE_UNKNOWN / _ERROR wrap
        return None
    return n
