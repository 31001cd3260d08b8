"""ctypes loader for the native host radius and kNN searches
(cpp/neighbor_search.cc).

The shared C++ source is compiled with g++ on first use into this package's
own build directory (``gaot_torch/_build/native``, rebuilt when the source
is newer). If it cannot be built, callers use the scipy search instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_ROOT), "cpp", "neighbor_search.cc")
_BUILD_DIR = os.path.join(_PKG_ROOT, "_build", "native")
_SO = os.path.join(_BUILD_DIR, "libgaot_neighbors.so")

_lock = threading.Lock()
_lib = None
_load_attempted = False


class NativeLib:
    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        self._lib.gaot_radius_count.restype = ctypes.c_int
        self._lib.gaot_radius_count.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_float, i64p,
        ]
        self._lib.gaot_radius_fill.restype = ctypes.c_int
        self._lib.gaot_radius_fill.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_float, i64p, i64p,
        ]
        self._lib.gaot_knn.restype = ctypes.c_int
        self._lib.gaot_knn.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, i64p,
        ]

    def radius_search(self, data: np.ndarray, queries: np.ndarray,
                      radius: float) -> Tuple[np.ndarray, np.ndarray]:
        """CSR (neighbors_index, row_splits) of all data points within
        ``radius`` of each query. data/queries: contiguous float32 [n, d]."""
        if data.dtype != np.float32 or queries.dtype != np.float32:
            raise TypeError("radius_search needs float32 points")
        n, dim = data.shape
        q = queries.shape[0]
        counts = np.zeros(q, dtype=np.int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        dp = data.ctypes.data_as(f32p)
        qp = queries.ctypes.data_as(f32p)
        rc = self._lib.gaot_radius_count(
            dp, n, qp, q, dim, radius, counts.ctypes.data_as(i64p))
        if rc != 0:
            raise RuntimeError(f"gaot_radius_count failed with code {rc}")
        row_splits = np.zeros(q + 1, dtype=np.int64)
        np.cumsum(counts, out=row_splits[1:])
        index = np.zeros(int(row_splits[-1]), dtype=np.int64)
        rc = self._lib.gaot_radius_fill(
            dp, n, qp, q, dim, radius,
            row_splits.ctypes.data_as(i64p), index.ctypes.data_as(i64p))
        if rc != 0:
            raise RuntimeError(f"gaot_radius_fill failed with code {rc}")
        return index, row_splits

    def knn_search(self, data: np.ndarray, queries: np.ndarray,
                   k: int) -> np.ndarray:
        """[q, k] indices of the k nearest data points of each query, each
        row sorted by (distance, index). data/queries: contiguous float32
        [n, d] with d in (2, 3); requires 1 <= k <= n."""
        if data.dtype != np.float32 or queries.dtype != np.float32:
            raise TypeError("knn_search needs float32 points")
        n, dim = data.shape
        q = queries.shape[0]
        out = np.empty((q, int(k)), dtype=np.int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.gaot_knn(
            data.ctypes.data_as(f32p), n, queries.ctypes.data_as(f32p), q,
            dim, int(k), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise RuntimeError(f"gaot_knn failed with code {rc}")
        return out


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, _SO)
    return True


def get_native_lib() -> Optional[NativeLib]:
    """The loaded native library, built if needed; None if unavailable."""
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if not os.path.exists(_SRC):
            return None
        stale = (not os.path.exists(_SO)
                 or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
        if stale and not _build():
            return None
        try:
            _lib = NativeLib(ctypes.CDLL(_SO))
        except (OSError, AttributeError):
            _lib = None
        return _lib
