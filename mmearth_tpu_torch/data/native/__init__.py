"""ctypes bindings for the native row-gather core (``gather.cc``, a copy of
the JAX package's), built with g++ at first use.

The library goes to ``build/native/libmmgather_<hash>.so`` at the root of the
checkout (the hash covers the source and the flags).  It is compiled to a
temporary name and renamed into place, so processes that build at once leave
one whole library.  A failed build raises with the compiler's output: there is
no fallback, and nothing on the loader's path gathers with numpy.
:func:`take_rows` is the plain version (``np.take``), kept for the tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "gather.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# the least bytes a thread of one call copies: a thread is started per
# call, so a small copy runs on one (see threads_for)
MIN_BYTES_PER_THREAD = 2 << 20

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
# calls of the native core that copied rows (what a run can read to show
# that its loader gathered through it)
CALLS = {"gather_rows": 0}


def _target() -> Path:
    tag = hashlib.sha1(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmmgather_{tag}.so"


def build() -> Path:
    """Compile ``gather.cc`` unless its library is built; returns its path."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run {CXX!r} to build the native gather: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mm_gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                                           ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
            lib.mm_gather_rows.restype = None
            lib.mm_prefetch_rows.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                             ctypes.c_void_p, ctypes.c_uint64]
            lib.mm_prefetch_rows.restype = None
            _lib = lib
    return _lib


def _rows(src: np.ndarray, rows) -> np.ndarray:
    """``rows`` as contiguous int64, every one a valid row of ``src``."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= len(src)):
        bad = rows[(rows < 0) | (rows >= len(src))][0]
        raise IndexError(f"row {bad} out of range for {len(src)} rows")
    return rows


def _check_layout(src: np.ndarray, out: np.ndarray, n: int) -> None:
    if out.shape != (n, *src.shape[1:]) or out.dtype != src.dtype:
        raise ValueError(f"out is {out.dtype}{out.shape}, expected {src.dtype}"
                         f"{(n, *src.shape[1:])}")
    if not (src[:1].flags.c_contiguous and out.flags.c_contiguous):
        raise ValueError("the native gather needs C-contiguous rows in src and out")
    if len(src) > 1 and n > 1 and src.strides[0] != out.strides[0]:
        raise ValueError(f"row strides differ: src {src.strides[0]}, out {out.strides[0]}")


def threads_for(nbytes: int, n_threads: int = 0) -> int:
    """Threads for a copy of ``nbytes``: at most ``n_threads`` (0: no cap of
    its own) and half the host's cores, and one per
    ``MIN_BYTES_PER_THREAD``.  On the H100 machine's 8-core host the gather
    of a batch peaks at 4 threads and falls below one thread's rate at 8
    (``scripts/torch_gather_bench.py``), and the training thread keeps a
    core of its own."""
    cap = max(1, (os.cpu_count() or 1) // 2)
    if n_threads > 0:
        cap = min(cap, n_threads)
    return max(1, min(cap, nbytes // MIN_BYTES_PER_THREAD))


def gather_rows(src: np.ndarray, rows, out: np.ndarray | None = None,
                n_threads: int = 0) -> np.ndarray:
    """``out[i] = src[rows[i]]`` through the native core, on at most
    ``n_threads`` threads (0: no cap of its own; :func:`threads_for`).  ``src``
    (an array or a memmap) and ``out`` hold C-contiguous rows of the same
    stride; a row out of range raises ``IndexError`` before any copy."""
    rows = _rows(src, rows)
    if out is None:
        out = np.empty((len(rows), *src.shape[1:]), dtype=src.dtype)
    _check_layout(src, out, len(rows))
    if len(rows):
        row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
        get_lib().mm_gather_rows(src.ctypes.data, out.ctypes.data, row_bytes,
                                 rows.ctypes.data, len(rows),
                                 threads_for(row_bytes * len(rows), n_threads))
        CALLS["gather_rows"] += 1
    return out


def prefetch_rows(src: np.ndarray, rows) -> None:
    """Ask the OS to page in ``rows`` of a memory-mapped ``src``."""
    rows = _rows(src, rows)
    if len(rows):
        row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
        get_lib().mm_prefetch_rows(src.ctypes.data, row_bytes, rows.ctypes.data, len(rows))


def take_rows(src: np.ndarray, rows, out: np.ndarray | None = None) -> np.ndarray:
    """The plain version of :func:`gather_rows` (``np.take``), with its bounds
    check."""
    rows = _rows(src, rows)
    if out is None:
        return np.take(src, rows, axis=0)
    _check_layout(src, out, len(rows))
    np.take(src, rows, axis=0, out=out, mode="clip")  # rows checked; "raise" would buffer
    return out
