"""Radius graphs, the vx node order and edge drop, in plain PyTorch and NumPy.

The benchmark's own rules for the graphs of the plain reference, written
from GAOT's description and the port's documented conventions, so that the
reference builds every graph again from the coordinates alone:

- :func:`radius_graph`: all sources within ``radius`` of each query, as an
  edge list sorted by query. The distance test is the float32 one of a
  grid-hash search with cells of side ``radius`` anchored 1e-6 below the
  sources' minimum (``d2 = dx*dx + dy*dy <= r*r``, each term rounded to
  float32), and each query lists its neighbours cell by cell (x offset -1,
  0, 1, then y offset), ascending by index within a cell: the order edge
  drop's uniforms are read in;
- :func:`morton_order`, :func:`rescale`: the vx node order (Z-order of 16
  bits an axis) and the per-sample min-max rescale a vx search runs on;
- :func:`draw_width`: the width of edge drop's draw, the widest degree
  bucket of the joint layout of every split's graphs of one side (an exact
  interval program over the degrees, as the port documents it);
- :func:`max_neighbors_keep`: the ``max_neighbors`` rule, each query keeping
  the slots whose uniform is at least its row's ``max_neighbors``-th
  largest.

Nothing here imports the measured program.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class Graph(NamedTuple):
    """Edges of one graph, sorted by query and then by slot: ``src`` [E]
    and ``dst`` [E] (int64), ``slot`` [E] (the edge's place in its query's
    list) and ``deg`` [Q]."""

    src: torch.Tensor
    dst: torch.Tensor
    slot: torch.Tensor
    deg: torch.Tensor

    def keep(self, mask: torch.Tensor) -> "Graph":
        """The graph of the edges where ``mask`` holds (slots as before)."""
        dst = self.dst[mask]
        deg = torch.bincount(dst, minlength=self.deg.shape[0])
        return Graph(self.src[mask], dst, self.slot[mask], deg)


def radius_graph(sources: torch.Tensor, queries: torch.Tensor, radius: float,
                 block: int = 2048) -> Graph:
    """Edges from every source within ``radius`` of each query. sources
    [N, d], queries [Q, d], float32 on any device."""
    src32 = sources.float().contiguous()
    qry32 = queries.float().contiguous()
    dev = src32.device
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = (r * r).to(dev)
    inv_cell = (torch.tensor(1.0, dtype=torch.float32) / r).to(dev)
    lo = src32.min(0).values - torch.tensor(1e-6, dtype=torch.float32, device=dev)
    cell_s = torch.floor((src32 - lo) * inv_cell).long()          # [N, d]
    n, d = src32.shape
    srcs, dsts, keys = [], [], []
    for q0 in range(0, qry32.shape[0], block):
        q = qry32[q0:q0 + block]
        cell_q = torch.floor((q - lo) * inv_cell).long()          # [b, d]
        off = cell_s[None] - cell_q[:, None]                       # [b, N, d]
        near = (off.abs() <= 1).all(-1)
        diff = src32[None] - q[:, None]                            # [b, N, d]
        d2 = diff[..., 0] * diff[..., 0]
        for k in range(1, d):
            d2 = d2 + diff[..., k] * diff[..., k]
        hit = near & (d2 <= r2)
        qi, sj = hit.nonzero(as_tuple=True)
        o = off[qi, sj] + 1                                        # [e, d] in 0..2
        cell_rank = o[:, 0]
        for k in range(1, d):
            cell_rank = cell_rank * 3 + o[:, k]
        srcs.append(sj)
        dsts.append(qi + q0)
        keys.append((qi + q0) * (3 ** d * n) + cell_rank * n + sj)
    src, dst, key = (torch.cat(t) for t in (srcs, dsts, keys))
    order = torch.argsort(key)
    src, dst = src[order], dst[order]
    deg = torch.bincount(dst, minlength=qry32.shape[0])
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(dst.shape[0], device=dev) - start[dst]
    return Graph(src, dst, slot, deg)


def morton_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order permutation of a point set [N, d] (keys of ``bits`` bits an
    axis over the set's bounding box, stable sort)."""
    coords = np.asarray(coords, dtype=np.float64)
    n, d = coords.shape
    lo = coords.min(axis=0)
    span = np.maximum(coords.max(axis=0) - lo, 1e-12)
    q = ((coords - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    key = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        for dim in range(d):
            key |= ((q[:, dim] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d + dim)
    return np.argsort(key, kind="stable")


def rescale(x: np.ndarray, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Min-max rescale of each axis to [lo, hi] (float64)."""
    x = np.asarray(x, dtype=np.float64)
    mn, mx = x.min(axis=0, keepdims=True), x.max(axis=0, keepdims=True)
    span = np.where(mx - mn == 0, 1.0, mx - mn)
    return (x - mn) / span * (hi - lo) + lo


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _bucket_ks(deg: np.ndarray, k_max: int, max_buckets: int, tile: int,
               penalty: int) -> List[int]:
    """Bucket widths minimising the padded rows read: an exact interval
    program over the distinct degrees (a bucket of degrees (prev, k] costs
    ceil(count / tile) · tile · k rows plus ``penalty``)."""
    deg = np.maximum(deg, 1)
    cand = np.unique(deg).astype(np.int64).tolist()
    if cand[-1] != k_max:
        cand.append(k_max)
    r = len(cand)
    counts = np.array([(deg <= c).sum() for c in cand], dtype=np.int64)

    def cost(i: int, j: int) -> int:
        n = counts[j] - (counts[i] if i >= 0 else 0)
        return 0 if n == 0 else int(-(-n // tile) * tile * cand[j] + penalty)

    inf = float("inf")
    best = [[inf] * (max_buckets + 1) for _ in range(r)]
    choice = [[-2] * (max_buckets + 1) for _ in range(r)]
    for j in range(r):
        for b in range(1, max_buckets + 1):
            c = cost(-1, j)
            if c < best[j][b]:
                best[j][b], choice[j][b] = c, -1
            for i in range(j):
                if best[i][b - 1] + cost(i, j) < best[j][b]:
                    best[j][b], choice[j][b] = best[i][b - 1] + cost(i, j), i
    ks, j, b = [], r - 1, max_buckets
    while j >= 0:
        ks.append(int(cand[j]))
        j = choice[j][b]
        b -= 1
    return sorted(ks)


def draw_width(degrees: np.ndarray, pad_multiple: int = 8, min_k: int = 6,
               tile: int = 8, max_buckets: int = 4, penalty: int = 256,
               min_gain: float = 1.15) -> int:
    """The width of edge drop's draw over one side's graphs, ``degrees``
    [S, Q] of every split's samples: the padded K (the largest degree
    rounded up to ``pad_multiple``), or, where degree buckets pay (K at
    least ``min_k`` and the dense rows over ``min_gain`` times the
    bucketed ones), the widest bucket that holds a row."""
    degrees = np.asarray(degrees, dtype=np.int64)
    s, q = degrees.shape
    k = _round_up(int(degrees.max()), pad_multiple)
    if k < min_k:
        return k
    ks = _bucket_ks(degrees.reshape(-1), k, max_buckets, tile, penalty)
    bid = np.searchsorted(np.asarray(ks), np.maximum(degrees, 1))
    rows = []
    for b in range(len(ks)):
        c = int((bid == b).sum(axis=1).max())
        rows.append(-(-c // tile) * tile if c else 0)
    kept = [(kb, rb) for kb, rb in zip(ks, rows) if rb > 0]
    bucketed = sum(kb * rb for kb, rb in kept)
    if bucketed == 0 or q * k < min_gain * bucketed:
        return k
    return max(kb for kb, _ in kept)


def max_neighbors_keep(graph: Graph, u: torch.Tensor, max_neighbors: int) -> torch.Tensor:
    """Which edges ``max_neighbors`` sampling keeps: ``u`` [Q, W] holds a
    uniform for each query's slot; a query keeps its edges whose uniform is
    at least the ``max_neighbors``-th largest of its edges' (all of them
    where it has no more)."""
    q, w = u.shape
    scores = torch.full((q, w), -1.0, dtype=u.dtype, device=u.device)
    mine = u[graph.dst, graph.slot]
    scores[graph.dst, graph.slot] = mine
    kth = torch.topk(scores, min(max_neighbors, w), dim=-1).values[:, -1]
    return mine >= kth[graph.dst]
