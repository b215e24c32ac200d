"""zstd decompression through the system's ``libzstd`` (``ctypes``).

The OCDBT store under an Orbax checkpoint compresses its nodes, and its zarr
arrays their chunks, as zstd frames (RFC 8878).  The port binds four
functions of the C library: ``ZSTD_decompress``,
``ZSTD_getFrameContentSize``, ``ZSTD_isError`` and ``ZSTD_getErrorName``.
The library is looked up at first use; where it is missing, that use raises
and names it.
"""
from __future__ import annotations

import ctypes
import ctypes.util

LIBRARY = "zstd"
# ZSTD_getFrameContentSize's two special returns
_UNKNOWN = 2 ** 64 - 1
_ERROR = 2 ** 64 - 2
# a frame that does not state its size is decoded into a buffer that
# doubles from this factor of its compressed size up to this many bytes
_GROWTH_START = 8
_MAX_UNSIZED = 1 << 32

_lib = None


def library() -> ctypes.CDLL:
    """The bound ``libzstd`` (loaded once)."""
    global _lib
    if _lib is None:
        name = ctypes.util.find_library(LIBRARY)
        if name is None:
            raise OSError(f"lib{LIBRARY} is not installed: reading an Orbax checkpoint needs "
                          "its zstd decompression")
        lib = ctypes.CDLL(name)
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = (ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t)
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = (ctypes.c_size_t,)
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = (ctypes.c_size_t,)
        _lib = lib
    return _lib


def decompress(data: bytes | bytearray | memoryview) -> bytearray:
    """The bytes of the zstd frame ``data``."""
    lib = library()
    src = bytes(data)
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == _ERROR:
        raise ValueError("not a zstd frame")
    if size != _UNKNOWN:
        return _into(lib, src, int(size), exact=True)
    cap = max(len(src) * _GROWTH_START, 1 << 16)
    while True:
        try:
            return _into(lib, src, cap, exact=False)
        except _TooSmall:
            if cap >= _MAX_UNSIZED:
                raise ValueError(f"a zstd frame of unstated size decodes past {cap} bytes")
            cap *= 2


class _TooSmall(Exception):
    pass


def _into(lib, src: bytes, cap: int, exact: bool) -> bytearray:
    out = bytearray(cap)
    buf = (ctypes.c_char * cap).from_buffer(out) if cap else None
    n = lib.ZSTD_decompress(buf, cap, src, len(src))
    del buf  # releases the export, so ``out`` can be resized
    if lib.ZSTD_isError(n):
        name = lib.ZSTD_getErrorName(n).decode()
        if not exact and "too small" in name:
            raise _TooSmall(name)
        raise ValueError(f"zstd: {name}")
    if exact and n != cap:
        raise ValueError(f"zstd: the frame states {cap} bytes and decodes to {n}")
    del out[n:]
    return out
