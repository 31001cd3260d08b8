"""Host-side fixed-radius and k-nearest-neighbor search.

Graph construction runs once per dataset on the host (fx mode) and emits
CSR arrays; ops/padding.py converts them to static-shape ``[Q, K]``
index/mask arrays for the device.

Methods:
  - ``cpp``:    native C++ grid-hash search (cpp/neighbor_search.cc via ctypes)
  - ``kdtree``: scipy cKDTree
  - ``grid``:   pure NumPy spatial hash (radius search only)
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
    """The radius search method ``method`` runs as on this host."""
    if method == "auto":
        return "cpp" if get_native_lib() is not None else "kdtree"
    if method == "cpp" and get_native_lib() is None:
        return "kdtree"
    if method not in ("cpp", "kdtree", "grid"):
        raise ValueError(f"Unknown neighbor search method: {method}")
    return method


def _radius_grid(data: np.ndarray, queries: np.ndarray, radius: float) -> CSR:
    """Pure-NumPy spatial-hash radius search (any dimension): data points
    bucketed by cells of side ``radius``, each query scanning the 3^d cells
    around its own (the JAX package's ``_radius_grid``)."""
    d = data.shape[1]
    lo = data.min(axis=0) - 1e-9
    keys_data = np.floor((data - lo) / radius).astype(np.int64)
    order = np.lexsort(keys_data.T[::-1])
    uniq, starts = np.unique(keys_data[order], axis=0, return_index=True)
    bucket = {tuple(k): (s, e) for k, s, e in zip(
        map(tuple, uniq), starts, np.append(starts[1:], len(order)))}
    offsets = np.stack(np.meshgrid(*([np.arange(-1, 2)] * d), indexing="ij"),
                       axis=-1).reshape(-1, d)
    keys_q = np.floor((queries - lo) / radius).astype(np.int64)
    r2 = radius * radius
    lists = []
    for qi in range(queries.shape[0]):
        cands = [order[se[0]:se[1]] for se in
                 (bucket.get(tuple(keys_q[qi] + off)) for off in offsets)
                 if se is not None]
        if not cands:
            lists.append(np.zeros(0, dtype=np.int64))
            continue
        cand = np.concatenate(cands)
        diff = data[cand] - queries[qi]
        lists.append(cand[(diff * diff).sum(axis=1) <= r2])
    return _csr_from_lists(lists)


def radius_search(data, queries, radius: float, method: str = "auto") -> CSR:
    """All points of ``data`` within ``radius`` of each query point, as CSR."""
    data = _as2d(data)
    queries = _as2d(queries)
    if data.shape[1] != queries.shape[1]:
        raise ValueError("data and queries must have the same coordinate dimension")
    method = resolve_method(method)
    if method == "cpp":
        return get_native_lib().radius_search(
            np.ascontiguousarray(data, dtype=np.float32),
            np.ascontiguousarray(queries, dtype=np.float32), float(radius))
    if method == "grid":
        return _radius_grid(data, queries, float(radius))
    from scipy.spatial import cKDTree

    tree = cKDTree(data)
    return _csr_from_lists(tree.query_ball_point(queries, r=radius, workers=-1))


def knn_search(data, queries, k: int, method: str = "auto") -> CSR:
    """The k nearest points of ``data`` to each query, as CSR in which every
    row has exactly k entries (k capped at the number of points).

    ``cpp`` runs the native grid search (2D and 3D, rows sorted by
    (distance, index)) and raises where it cannot; ``kdtree`` runs scipy's
    cKDTree; ``auto`` takes cpp for 2D/3D points where the library builds,
    else kdtree. Other methods are rejected."""
    data = _as2d(data)
    queries = _as2d(queries)
    if data.shape[1] != queries.shape[1]:
        raise ValueError("data and queries must have the same coordinate dimension")
    k = min(k, data.shape[0])
    if method not in ("auto", "cpp", "kdtree"):
        raise ValueError(f"Unknown kNN search method: {method}")
    row_splits = np.arange(queries.shape[0] + 1, dtype=np.int64) * k
    if method in ("auto", "cpp"):
        lib = get_native_lib()
        if lib is not None and data.shape[1] in (2, 3):
            idx = lib.knn_search(np.ascontiguousarray(data, dtype=np.float32),
                                 np.ascontiguousarray(queries, dtype=np.float32), k)
            return idx.reshape(-1), row_splits
        if method == "cpp":
            raise RuntimeError(
                "knn_search(method='cpp'): native library unavailable or "
                f"unsupported dim {data.shape[1]} (2D/3D only)")
    from scipy.spatial import cKDTree

    _, idx = cKDTree(data).query(queries, k=k, workers=-1)
    idx = np.asarray(idx).reshape(queries.shape[0], k)
    return idx.reshape(-1).astype(np.int64), row_splits
