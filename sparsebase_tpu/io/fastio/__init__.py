"""ctypes bindings + lazy build of the native parallel parser.

The PIGO-equivalent native I/O path (reference:
src/sparsebase/external/pigo/pigo.hpp + io/pigo_*_reader.cc): mmap +
OpenMP chunked parsing in C++ (fastio.cpp), loaded through ctypes. The
library is compiled on first use with g++ and rebuilt whenever the
source or flags change (``utils.native_build``); if no toolchain is
available, callers fall back to the numpy parser
(``available()`` returns False).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ...utils.native_build import ensure_built

_HERE = Path(__file__).parent
_SRC = _HERE / "fastio.cpp"
_LIB_PATH = _HERE / "libfastio.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    try:
        ensure_built(_SRC, _LIB_PATH, timeout=120)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _build_failed = True
            return None
        lib.sbtpu_count_entries.restype = ctypes.c_int64
        lib.sbtpu_count_entries.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.sbtpu_parse_entries.restype = ctypes.c_int64
        lib.sbtpu_parse_entries.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.sbtpu_parse_values.restype = ctypes.c_int64
        lib.sbtpu_parse_values.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.sbtpu_sort_packed.restype = ctypes.c_int64
        lib.sbtpu_sort_packed.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sbtpu_sort_packed_weighted.restype = ctypes.c_int64
        lib.sbtpu_sort_packed_weighted.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.sbtpu_argsort_pairs.restype = ctypes.c_int64
        lib.sbtpu_argsort_pairs.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def count_entries(path: str, offset: int) -> int:
    lib = _load()
    n = lib.sbtpu_count_entries(path.encode(), offset)
    if n < 0:
        raise OSError(f"fastio: cannot read {path}")
    return int(n)


def parse_entries(
    path: str, offset: int, weighted: bool, out=None
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Parse `u v [w]` lines after byte `offset`; returns (rows, cols, vals).

    ``out=(rows, cols, vals)`` reuses caller-provided int64/int64/float64
    buffers (sliced to the parsed count): on hosts where first-touch
    page faults are slow, reusing warm buffers across parses saves the
    fault cost of fresh multi-GB allocations."""
    lib = _load()
    n = count_entries(path, offset)
    if out is not None:
        rows, cols, vals = out[0][:n], out[1][:n], (
            out[2][:n] if weighted else None
        )
        if len(rows) < n or len(cols) < n or (weighted and len(vals) < n):
            raise ValueError(f"fastio: out buffers smaller than {n} entries")
    else:
        rows = np.empty(n, np.int64)
        cols = np.empty(n, np.int64)
        vals = np.empty(n, np.float64) if weighted else None
    got = lib.sbtpu_parse_entries(
        path.encode(),
        offset,
        3 if weighted else 2,
        n,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if weighted else None,
    )
    if got < 0:
        raise OSError(f"fastio: cannot read {path}")
    return rows[:got], cols[:got], (vals[:got] if weighted else None)


def sort_pairs_inplace(
    major: np.ndarray, minor: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Row-major sort of a PATTERN pair list — packed-u64 native sort
    with no index payload and no apply-gathers (~2× the argsort path at
    50M entries). Returns sorted int64 copies, or None when the native
    library is unavailable or keys exceed u32 (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    mj = np.array(major, np.int64, copy=True)
    mn = np.array(minor, np.int64, copy=True)
    ok = lib.sbtpu_sort_packed(
        len(mj),
        mj.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return (mj, mn) if ok == 1 else None


def sort_pairs_weighted_inplace(major, minor, vals):
    """Row-major sort of a weighted entry list: (packed-u64 key, f64
    value) structs sorted by key — the value rides the native sort, so
    no index argsort and no apply-gathers. Returns sorted (int64, int64,
    float64) copies or None (unavailable / keys exceed u32). Unstable
    ties are unobservable (duplicate coordinates accumulate)."""
    lib = _load()
    if lib is None:
        return None
    mj = np.array(major, np.int64, copy=True)
    mn = np.array(minor, np.int64, copy=True)
    vv = np.array(vals, np.float64, copy=True)
    ok = lib.sbtpu_sort_packed_weighted(
        len(mj),
        mj.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return (mj, mn, vv) if ok == 1 else None


def argsort_pairs(major: np.ndarray, minor: np.ndarray) -> Optional[np.ndarray]:
    """Parallel stable argsort by (major, minor) — the host row-major COO
    sort, multi-threaded (np.lexsort is single-threaded: ~35 s at 50M on
    this box vs a few seconds here). Returns None when the native lib is
    unavailable or dtypes are not int32/int64 (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    if major.dtype not in (np.int32, np.int64) or minor.dtype not in (
        np.int32,
        np.int64,
    ):
        return None
    major = np.ascontiguousarray(major)
    minor = np.ascontiguousarray(minor)
    n = len(major)
    order = np.empty(n, np.int64)
    got = lib.sbtpu_argsort_pairs(
        n,
        major.ctypes.data_as(ctypes.c_void_p),
        minor.ctypes.data_as(ctypes.c_void_p),
        1 if major.dtype == np.int64 else 0,
        1 if minor.dtype == np.int64 else 0,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if got != n:
        return None
    return order


def parse_values(path: str, offset: int) -> np.ndarray:
    lib = _load()
    n = count_entries(path, offset)
    vals = np.empty(n, np.float64)
    got = lib.sbtpu_parse_values(
        path.encode(), offset, n, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    )
    if got < 0:
        raise OSError(f"fastio: cannot read {path}")
    return vals[:got]
