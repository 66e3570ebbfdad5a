"""ctypes bindings + lazy build of the native graph-algorithm kernels.

The host-side irregular algorithms (SlashBurn, RCM, Rabbit clustering,
minimum-degree, multilevel partitioning) are sequential/data-dependent —
the part the reference implements in C++ (reference:
src/sparsebase/reorder/*.cc, partition/*.cc). graphkit.cpp provides
C++17 implementations that mirror the numpy reference paths exactly
(same deterministic tie-breaking), loaded through ctypes like io/fastio.
The library is compiled from graphkit.cpp on first use with g++ and
rebuilt whenever the source or flags change (``utils.native_build``);
without a toolchain callers fall back to the numpy implementations
(``available()`` returns False). The global toggle is
``config.use_graphkit``.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.native_build import ensure_built

_HERE = Path(__file__).parent
_SRC = _HERE / "graphkit.cpp"
_LIB_PATH = _HERE / "libgraphkit.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def _build() -> bool:
    try:
        ensure_built(_SRC, _LIB_PATH, timeout=180)
        return True
    except subprocess.CalledProcessError as e:
        from ..utils.logger import Logger

        Logger("graphkit").warning(
            "native build failed; falling back to numpy paths:\n"
            + e.stderr.decode(errors="replace")[:2000]
        )
        return False
    except (OSError, subprocess.TimeoutExpired):
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
        lib.sbtpu_slashburn.restype = ctypes.c_int64
        lib.sbtpu_slashburn.argtypes = [
            ctypes.c_int64, _I64P, _I64P, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, _I64P,
        ]
        lib.sbtpu_rcm.restype = ctypes.c_int64
        lib.sbtpu_rcm.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I64P]
        lib.sbtpu_rabbit.restype = ctypes.c_int64
        lib.sbtpu_rabbit.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P]
        lib.sbtpu_amd.restype = ctypes.c_int64
        lib.sbtpu_amd.argtypes = [
            ctypes.c_int64, _I64P, _I64P, ctypes.c_double, ctypes.c_int64,
            _I64P,
        ]
        lib.sbtpu_partition_kway.restype = ctypes.c_int64
        lib.sbtpu_partition_kway.argtypes = [
            ctypes.c_int64, _I64P, _I64P, _F64P, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _I64P,
        ]
        lib.sbtpu_nested_dissection.restype = ctypes.c_int64
        lib.sbtpu_nested_dissection.argtypes = [
            ctypes.c_int64, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, _I64P,
        ]
        lib.sbtpu_pulp.restype = ctypes.c_int64
        lib.sbtpu_pulp.argtypes = [
            ctypes.c_int64, _I64P, _I64P, _I64P, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64, _I64P,
        ]
        lib.sbtpu_jaccard.restype = ctypes.c_int64
        lib.sbtpu_jaccard.argtypes = [
            ctypes.c_int64, _I64P, _I64P, ctypes.POINTER(ctypes.c_float),
        ]
        lib.sbtpu_triangles.restype = ctypes.c_int64
        lib.sbtpu_triangles.argtypes = [
            ctypes.c_int64, _I64P, _I64P, ctypes.c_int, _I64P,
        ]
        lib.sbtpu_fill_in.restype = ctypes.c_int64
        lib.sbtpu_fill_in.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is loadable AND config enables it."""
    from ..config import get_config

    if not get_config().use_graphkit:
        return False
    return _load() is not None


def _csr64(indptr, indices):
    ip = np.ascontiguousarray(np.asarray(indptr), dtype=np.int64)
    ix = np.ascontiguousarray(np.asarray(indices), dtype=np.int64)
    return ip, ix


def slashburn(n, indptr, indices, k_size, greedy, hub_order) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    out = np.empty(n, np.int64)
    rc = lib.sbtpu_slashburn(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        int(k_size), int(bool(greedy)), int(bool(hub_order)),
        out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit slashburn failed")
    return out


def rcm(nrows, ncols, indptr, indices) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    n = max(nrows, ncols)
    out = np.empty(n, np.int64)
    rc = lib.sbtpu_rcm(
        nrows, ncols, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit rcm failed")
    return out


def rabbit(n, indptr, indices) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    out = np.empty(n, np.int64)
    rc = lib.sbtpu_rabbit(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit rabbit failed")
    return out


def amd(n, indptr, indices, dense_threshold, aggressive=True) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    out = np.empty(n, np.int64)
    thr = float(dense_threshold) if np.isfinite(dense_threshold) else 1e300
    rc = lib.sbtpu_amd(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P), thr,
        int(bool(aggressive)), out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit amd failed")
    return out


def nested_dissection(n, indptr, indices, seed, ufactor, niter, leaf_size) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    out = np.empty(n, np.int64)
    rc = lib.sbtpu_nested_dissection(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        int(seed), int(ufactor), int(niter), int(leaf_size),
        out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit nested_dissection failed")
    return out


def pulp(n, indptr, indices, seeds, k, cap, iters) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    sd = np.ascontiguousarray(np.asarray(seeds), dtype=np.int64)
    out = np.empty(n, np.int64)
    rc = lib.sbtpu_pulp(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        sd.ctypes.data_as(_I64P), len(sd), int(k), float(cap), int(iters),
        out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit pulp failed")
    return out


def jaccard(n, indptr, indices, nnz) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    out = np.empty(nnz, np.float32)
    rc = lib.sbtpu_jaccard(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise RuntimeError("graphkit jaccard failed")
    return out


def triangles(n, indptr, indices, directed) -> int:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    out = np.zeros(1, np.int64)
    rc = lib.sbtpu_triangles(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        int(bool(directed)), out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit triangles failed")
    return int(out[0])


def partition_kway(n, indptr, indices, ewts, k, seed, ufactor, niter) -> np.ndarray:
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    ew = None
    ewp = None
    if ewts is not None:
        ew = np.ascontiguousarray(np.asarray(ewts), dtype=np.float64)
        ewp = ew.ctypes.data_as(_F64P)
    out = np.empty(n, np.int64)
    rc = lib.sbtpu_partition_kway(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P), ewp,
        int(k), int(seed), int(ufactor), int(niter),
        out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit partition failed")
    return out


def fill_in(n, indptr, indices) -> int:
    """Symbolic-factorization nnz(L) (mirror of ops/feature/fill.py)."""
    lib = _load()
    ip, ix = _csr64(indptr, indices)
    out = np.zeros(1, np.int64)
    rc = lib.sbtpu_fill_in(
        n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
        out.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError("graphkit fill_in failed")
    return int(out[0])
