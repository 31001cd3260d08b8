"""Host-side fixed-radius neighbor search.

Graph construction runs once per dataset on the host (fx mode) and emits
CSR arrays; ops/padding.py converts them to static-shape ``[Q, K]``
index/mask arrays for the device.

Methods:
  - ``cpp``:    native C++ grid-hash search (cpp/neighbor_search.cc via ctypes)
  - ``kdtree``: scipy cKDTree
  - ``auto``:   cpp if the shared library builds, else kdtree
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .native import get_native_lib

CSR = Tuple[np.ndarray, np.ndarray]  # (neighbors_index [E], row_splits [Q+1]) int64


def _as2d(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
    if x.ndim != 2:
        raise ValueError(f"points must be 2D [n, d], got shape {x.shape}")
    return x


def _csr_from_lists(lists) -> CSR:
    counts = np.fromiter((len(l) for l in lists), dtype=np.int64, count=len(lists))
    row_splits = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum(counts, out=row_splits[1:])
    if row_splits[-1] == 0:
        return np.zeros(0, dtype=np.int64), row_splits
    index = np.concatenate([np.asarray(l, dtype=np.int64) for l in lists if len(l)])
    return index, row_splits


def resolve_method(method: str) -> str:
    """The search method ``method`` runs as on this host."""
    if method == "auto":
        return "cpp" if get_native_lib() is not None else "kdtree"
    if method == "cpp" and get_native_lib() is None:
        return "kdtree"
    if method not in ("cpp", "kdtree"):
        raise ValueError(f"Unknown neighbor search method: {method}")
    return method


def radius_search(data, queries, radius: float, method: str = "auto") -> CSR:
    """All points of ``data`` within ``radius`` of each query point, as CSR."""
    data = _as2d(data)
    queries = _as2d(queries)
    if data.shape[1] != queries.shape[1]:
        raise ValueError("data and queries must have the same coordinate dimension")
    if resolve_method(method) == "cpp":
        return get_native_lib().radius_search(
            np.ascontiguousarray(data, dtype=np.float32),
            np.ascontiguousarray(queries, dtype=np.float32), float(radius))
    from scipy.spatial import cKDTree

    tree = cKDTree(data)
    return _csr_from_lists(tree.query_ball_point(queries, r=radius, workers=-1))
