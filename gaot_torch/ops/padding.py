"""CSR → padded static-shape graph conversion (host side, NumPy).

The reference keeps ragged CSR neighbor lists and reduces them with
torch_scatter's segment_csr. This package converts CSR graphs once, on the
host, into dense ``[num_queries, K]`` index arrays plus boolean masks, so
every device-side reduction is a dense masked reduce. K is the max row
length rounded up to ``pad_multiple``, optionally capped.

The graph containers hold NumPy arrays while they are built;
:func:`graph_to_device` turns any of them into the same container of torch
tensors on a device. The fx layouts: the dense graph, its transpose, the
degree-bucketed graph and the in-degree-grouped transpose. The vx layouts
(one mesh per sample): per-sample graphs stacked to [S, Q, K]
(:func:`stack_graphs`), their Morton node order (:func:`morton_order`),
stacked transpose graphs (:func:`stack_tgraphs`) and the shared-layout
degree buckets (:class:`BatchedBucketedGraph`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class PaddedGraph(NamedTuple):
    """Static-shape neighborhood graph.

    indices: int [*, Q, K] — neighbor indices into the source point set;
        padded entries are 0 (a valid index, masked out by `mask`).
    mask: bool [*, Q, K] — True for real neighbors.
    """

    indices: np.ndarray
    mask: np.ndarray

    @property
    def num_queries(self) -> int:
        return self.indices.shape[-2]

    @property
    def k(self) -> int:
        return self.indices.shape[-1]


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def morton_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order (Morton) permutation of a point set [N, d] (d in {2, 3}).

    Spatially sorted nodes make radius-graph neighbour indices of nearby
    queries cluster, so the rows the reduces read by index lie close
    together. Applied per sample at the vx graph build."""
    coords = np.asarray(coords, dtype=np.float64)
    n, d = coords.shape
    lo = coords.min(axis=0)
    rng = np.maximum(coords.max(axis=0) - lo, 1e-12)
    q = ((coords - lo) / rng * ((1 << bits) - 1)).astype(np.uint64)
    key = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        for dim in range(d):
            key |= ((q[:, dim] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * d + dim)
    return np.argsort(key, kind="stable")


def pad_csr(
    neighbors_index: np.ndarray,
    row_splits: np.ndarray,
    pad_multiple: int = 8,
    cap: Optional[int] = None,
    k: Optional[int] = None,
) -> PaddedGraph:
    """Convert a CSR neighbor list to a PaddedGraph.

    Args:
        neighbors_index: int [E] flat neighbor indices.
        row_splits: int [Q+1] CSR row splits.
        pad_multiple: round K up to a multiple of this.
        cap: optional hard cap on K; longer rows are truncated (keeping the
            first `cap` entries).
        k: force an exact K (overrides pad_multiple/cap); rows longer than k
            are truncated.
    """
    row_splits = np.asarray(row_splits, dtype=np.int64)
    neighbors_index = np.asarray(neighbors_index, dtype=np.int64)
    counts = row_splits[1:] - row_splits[:-1]
    q = counts.shape[0]
    max_count = int(counts.max()) if q else 0
    if k is None:
        k = _round_up(max_count, pad_multiple)
        if cap is not None:
            k = min(k, _round_up(cap, 1))
    indices = np.zeros((q, k), dtype=np.int32)
    kept = np.minimum(counts, k)
    col = np.arange(k)[None, :]
    mask = col < kept[:, None]
    flat_pos = (row_splits[:-1][:, None] + col)[mask]
    indices[mask] = neighbors_index[flat_pos].astype(np.int32)
    return PaddedGraph(indices=indices, mask=mask)


def repad(graph: PaddedGraph, k: int) -> PaddedGraph:
    """Re-pad (or truncate) a graph to an exact K."""
    old_k = graph.indices.shape[-1]
    if old_k == k:
        return graph
    if old_k > k:
        return PaddedGraph(graph.indices[..., :k], graph.mask[..., :k])
    pad = [(0, 0)] * (graph.indices.ndim - 1) + [(0, k - old_k)]
    return PaddedGraph(
        np.pad(graph.indices, pad), np.pad(graph.mask, pad, constant_values=False))


def stack_graphs(graphs: Sequence[PaddedGraph]) -> PaddedGraph:
    """Stack per-sample graphs to a batched PaddedGraph [S, Q, K], re-padded
    to the largest K; query counts must already match."""
    k = max(g.k for g in graphs)
    graphs = [repad(g, k) for g in graphs]
    return PaddedGraph(indices=np.stack([g.indices for g in graphs]),
                       mask=np.stack([g.mask for g in graphs]))


def padded_from_search(search_result: dict, pad_multiple: int = 8,
                       cap: Optional[int] = None, k: Optional[int] = None) -> PaddedGraph:
    """Pad a search result given as a dict of CSR arrays
    (``neighbors_index``, ``neighbors_row_splits``)."""
    return pad_csr(search_result["neighbors_index"],
                   search_result["neighbors_row_splits"],
                   pad_multiple=pad_multiple, cap=cap, k=k)


class TransposeGraph(NamedTuple):
    """Reverse adjacency of a PaddedGraph, for scatter-free backward passes.

    For forward edges (q, k) → n = indices[q, k], stores for every source
    node n its incoming edges:
      edge_pos: int [N, Kt] — flat forward edge position q * K + k
      query:    int [N, Kt] — the query q of that edge
      mask:     bool [N, Kt]
    """

    edge_pos: np.ndarray
    query: np.ndarray
    mask: np.ndarray

    @property
    def kt(self) -> int:
        return self.edge_pos.shape[-1]


def transpose_graph(graph: PaddedGraph, num_sources: int,
                    pad_multiple: int = 8) -> TransposeGraph:
    """Build the reverse adjacency of a padded graph on the host."""
    q, k = graph.indices.shape
    flat_src = graph.indices.reshape(-1).astype(np.int64)
    flat_mask = graph.mask.reshape(-1)
    edge_ids = np.nonzero(flat_mask)[0]
    srcs = flat_src[edge_ids]
    order = np.argsort(srcs, kind="stable")
    srcs_sorted = srcs[order]
    edges_sorted = edge_ids[order]
    counts = np.bincount(srcs_sorted, minlength=num_sources)
    row_splits = np.zeros(num_sources + 1, dtype=np.int64)
    np.cumsum(counts, out=row_splits[1:])
    padded = pad_csr(edges_sorted, row_splits, pad_multiple=pad_multiple)
    queries = (padded.indices // k).astype(np.int32)
    return TransposeGraph(edge_pos=padded.indices, query=queries,
                          mask=padded.mask)


class GroupedTransposeGraph(NamedTuple):
    """A stacked per-sample TransposeGraph re-packed into in-degree groups.

    In-degree is heavy-tailed, so a single [N, Kt] transpose graph is mostly
    masked padding. Rows (source nodes) are sorted by in-degree per sample,
    the rank space is cut at shared static boundaries, and each group is
    padded only to its own max degree.

    groups:   per-group stacked TransposeGraphs [B, R_j, Ktj] in ascending
              degree order, rows degree-sorted PER SAMPLE, indices kept
              per-sample LOCAL;
    inv_perm: int [B, S] — original row r of sample b sits at grouped
              (concatenated) position inv_perm[b, r].
    """

    groups: Tuple[TransposeGraph, ...]
    inv_perm: np.ndarray


def _group_boundaries(deg_sorted_max: np.ndarray, max_groups: int = 4,
                      grid: int = 64, pad: int = 8):
    """Rank-space boundaries minimizing total padded rows gathered.

    deg_sorted_max: [S] — max over samples of the per-rank degree after the
    per-sample ascending sort (monotone). DP over a coarse grid: cost of
    group [lo, hi) = (hi − lo) · deg_sorted_max[hi − 1]."""
    s = deg_sorted_max.shape[0]
    grid = max(pad, min(grid, -(-s // 16) // pad * pad or pad))
    pts = sorted({0, s, *(min(s, g * grid) for g in range(1, s // grid + 2))})
    pts = [p for p in pts if p == 0 or p == s or p % pad == 0]
    best = {0: (0.0, [0])}
    for _ in range(max_groups):
        nxt = {}
        for lo, (cost, path) in best.items():
            for hi in pts:
                if hi <= lo:
                    continue
                c = cost + (hi - lo) * int(deg_sorted_max[hi - 1])
                if hi not in nxt or c < nxt[hi][0]:
                    nxt[hi] = (c, path + [hi])
        for k, v in nxt.items():
            if k not in best or v[0] < best[k][0]:
                best[k] = v
    return best[s][1]


def degree_group_tgraph(tgraph: TransposeGraph,
                        max_groups: int = 4) -> GroupedTransposeGraph:
    """Degree-group a STACKED per-sample transpose graph [B, S, Kt].

    Boundaries come from the rank-space degree envelope over all samples and
    each group's Ktj is the max degree any sample reaches inside it."""
    ep, tq, tm = (np.asarray(tgraph.edge_pos), np.asarray(tgraph.query),
                  np.asarray(tgraph.mask))
    deg = tm.sum(-1)
    perm = np.argsort(deg, axis=1, kind="stable")
    inv_perm = np.argsort(perm, axis=1).astype(np.int32)
    deg_sorted = np.take_along_axis(deg, perm, axis=1)
    bounds = _group_boundaries(deg_sorted.max(0), max_groups=max_groups)
    ep_p = np.take_along_axis(ep, perm[:, :, None], axis=1)
    tq_p = np.take_along_axis(tq, perm[:, :, None], axis=1)
    tm_p = np.take_along_axis(tm, perm[:, :, None], axis=1)
    groups = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        kg = max(1, int(deg_sorted[:, lo:hi].max()))
        groups.append(TransposeGraph(
            np.ascontiguousarray(ep_p[:, lo:hi, :kg]),
            np.ascontiguousarray(tq_p[:, lo:hi, :kg]),
            np.ascontiguousarray(tm_p[:, lo:hi, :kg])))
    return GroupedTransposeGraph(tuple(groups), inv_perm)


def repad_tgraph(tgraph: TransposeGraph, kt: int) -> TransposeGraph:
    """Re-pad (or truncate) a transpose graph to an exact Kt."""
    old = tgraph.edge_pos.shape[-1]
    if old == kt:
        return tgraph
    if old > kt:
        return TransposeGraph(tgraph.edge_pos[..., :kt], tgraph.query[..., :kt],
                              tgraph.mask[..., :kt])
    pad = [(0, 0)] * (tgraph.edge_pos.ndim - 1) + [(0, kt - old)]
    return TransposeGraph(
        np.pad(tgraph.edge_pos, pad), np.pad(tgraph.query, pad),
        np.pad(tgraph.mask, pad, constant_values=False))


def stack_tgraphs(tgraphs: Sequence[TransposeGraph]) -> TransposeGraph:
    """Stack per-sample transpose graphs to [S, N, Kt] (re-padded to the
    largest Kt)."""
    kt = max(t.kt for t in tgraphs)
    tgraphs = [repad_tgraph(t, kt) for t in tgraphs]
    return TransposeGraph(edge_pos=np.stack([t.edge_pos for t in tgraphs]),
                          query=np.stack([t.query for t in tgraphs]),
                          mask=np.stack([t.mask for t in tgraphs]))


class BucketedGraph(NamedTuple):
    """A PaddedGraph re-packed into degree buckets.

    Radius-graph neighbor counts are heavy-tailed, so a single dense [Q, K]
    layout spends most of its gather traffic and per-edge kernel-MLP work on
    padding. Queries are sorted by degree and partitioned into a few
    buckets, each padded only to its own K — the per-query math is
    unchanged (same real edges, same left-packed order).

    buckets: per-bucket subgraphs in ascending-K order; query rows of bucket
        i occupy concat positions [Σ_{j<i} rows_j, …) (each bucket's row
        count is tile-padded).
    tgraph: ONE transpose graph for the scatter-free backward, indexing the
        bucket-CONCATENATED edge/row spaces (a TransposeGraph, or its
        GroupedTransposeGraph form).
    perm: int [R] — concat position → original query index (0 on pad rows).
    inv_perm: int [Q] — original query index → concat position.
    row_valid: bool [R] — False on per-bucket tile-padding rows.
    """

    buckets: Tuple[PaddedGraph, ...]
    tgraph: Optional[TransposeGraph]
    perm: np.ndarray
    inv_perm: np.ndarray
    row_valid: np.ndarray

    @property
    def num_queries(self) -> int:
        return self.inv_perm.shape[-1]


def transpose_bucket_edges(buckets: Sequence[PaddedGraph], num_sources: int,
                           pad_multiple: int = 8) -> TransposeGraph:
    """Combined reverse adjacency of a bucket list, in concat edge/row space."""
    srcs_l, qrows_l, eids_l = [], [], []
    row_off, edge_off = 0, 0
    for g in buckets:
        rr, kk = np.nonzero(g.mask)
        srcs_l.append(g.indices[rr, kk].astype(np.int64))
        qrows_l.append(rr.astype(np.int64) + row_off)
        eids_l.append(edge_off + rr.astype(np.int64) * g.k + kk)
        row_off += g.num_queries
        edge_off += g.indices.size
    srcs = np.concatenate(srcs_l)
    qrows = np.concatenate(qrows_l)
    eids = np.concatenate(eids_l)
    order = np.argsort(srcs, kind="stable")
    counts = np.bincount(srcs[order], minlength=num_sources)
    row_splits = np.zeros(num_sources + 1, dtype=np.int64)
    np.cumsum(counts, out=row_splits[1:])
    padded_e = pad_csr(eids[order], row_splits, pad_multiple=pad_multiple)
    padded_q = pad_csr(qrows[order], row_splits, pad_multiple=pad_multiple)
    return TransposeGraph(edge_pos=padded_e.indices, query=padded_q.indices,
                          mask=padded_e.mask)


def _choose_bucket_ks(deg: np.ndarray, k_max: int, max_buckets: int,
                      tile: int, launch_penalty_rows: int) -> list:
    """Pick bucket K values minimizing total gathered rows.

    Exact interval DP over the unique degree values: a bucket covering
    degrees (prev, k] costs ceil(count/tile)·tile·k rows plus a fixed
    per-bucket penalty (launch cost expressed in gathered rows)."""
    deg = np.maximum(deg, 1)
    cand = np.unique(deg).astype(np.int64).tolist()
    if cand[-1] != k_max:
        cand.append(k_max)
    r = len(cand)
    counts = np.array([(deg <= c).sum() for c in cand], dtype=np.int64)

    def bucket_cost(i: int, j: int) -> int:
        n = counts[j] - (counts[i] if i >= 0 else 0)
        if n == 0:
            return 0
        return int(-(-n // tile) * tile * cand[j] + launch_penalty_rows)

    INF = float("inf")
    best = [[INF] * (max_buckets + 1) for _ in range(r)]
    choice = [[-2] * (max_buckets + 1) for _ in range(r)]
    for j in range(r):
        for b in range(1, max_buckets + 1):
            c = bucket_cost(-1, j)
            if c < best[j][b]:
                best[j][b] = c
                choice[j][b] = -1
            for i in range(j):
                if best[i][b - 1] + bucket_cost(i, j) < best[j][b]:
                    best[j][b] = best[i][b - 1] + bucket_cost(i, j)
                    choice[j][b] = i
    ks = []
    j, b = r - 1, max_buckets
    while j >= 0:
        ks.append(int(cand[j]))
        j = choice[j][b]
        b -= 1
    return sorted(ks)


def _bucket_layout(graph: PaddedGraph, tile: int, max_buckets: int,
                   launch_penalty_rows: int, min_gain: float, min_k: int):
    """The degree-bucket decision of :func:`bucketize_graph`: (the bucket
    K values, each query's bucket), or None where the dense layout stays."""
    if graph.indices.ndim != 2 or graph.indices.shape[-1] < min_k:
        return None
    q, k = graph.indices.shape
    deg = graph.mask.sum(-1).astype(np.int64)
    ks = _choose_bucket_ks(deg, k, max_buckets, tile, launch_penalty_rows)
    bucketed_rows = 0
    bid = np.searchsorted(np.asarray(ks), np.maximum(deg, 1))
    for b, kb in enumerate(ks):
        n = int((bid == b).sum())
        bucketed_rows += -(-max(n, 0) // tile) * tile * kb if n else 0
    if bucketed_rows == 0 or q * k < min_gain * bucketed_rows:
        return None
    return ks, bid


def bucketize_graph(graph: PaddedGraph, num_sources: int,
                    with_transpose: bool = True, tile: int = 128,
                    max_buckets: int = 4, launch_penalty_rows: int = 1024,
                    min_gain: float = 1.15,
                    min_k: int = 12) -> Optional[BucketedGraph]:
    """Re-pack a [Q, K] PaddedGraph into degree buckets.

    Returns None when the dense layout is already within ``min_gain`` of the
    bucketed row count (uniform-degree graphs), or when K < ``min_k``
    (small-K graphs keep the dense layout). The decision and the layout are
    the JAX package's, so both packages build identical graphs.
    """
    layout = _bucket_layout(graph, tile, max_buckets, launch_penalty_rows, min_gain,
                            min_k)
    if layout is None:
        return None
    ks, bid = layout
    q = graph.indices.shape[0]
    order = np.argsort(bid, kind="stable")
    buckets = []
    perm_parts, valid_parts = [], []
    inv_perm = np.zeros(q, dtype=np.int32)
    offset = 0
    for b, kb in enumerate(ks):
        rows = order[bid[order] == b]
        n = rows.shape[0]
        if n == 0:
            continue
        npad = -(-n // tile) * tile
        idx = np.zeros((npad, kb), dtype=np.int32)
        msk = np.zeros((npad, kb), dtype=bool)
        idx[:n] = graph.indices[rows, :kb]
        msk[:n] = graph.mask[rows, :kb]
        buckets.append(PaddedGraph(idx, msk))
        inv_perm[rows] = offset + np.arange(n, dtype=np.int32)
        perm_parts.append(np.pad(rows.astype(np.int32), (0, npad - n)))
        valid_parts.append(np.arange(npad) < n)
        offset += npad
    tg = (transpose_bucket_edges(buckets, num_sources)
          if with_transpose else None)
    return BucketedGraph(
        buckets=tuple(buckets),
        tgraph=tg,
        perm=np.concatenate(perm_parts),
        inv_perm=inv_perm,
        row_valid=np.concatenate(valid_parts),
    )


class BatchedBucketedGraph(NamedTuple):
    """Per-sample degree-bucketed graphs with a shared bucket layout (vx).

    Every sample's [Q, K] graph is re-packed into the same bucket K values
    (chosen from the split-wide degree distribution), each bucket's row
    count padded to the split-wide maximum, so a whole split shares one
    shape per bucket and a batch is a selection of samples.

    buckets: per-bucket subgraphs, indices/mask [S, R_b, K_b] (ascending K).
    tgraph: per-sample combined transpose graphs (stacked [S, N_src, Kt], or
        their GroupedTransposeGraph); edge_pos / query address each
        sample's own bucket-concatenated edge / row spaces (edge base
        Σ_{j<b} R_j·K_j, edge r·K_b + k within bucket b; row base
        Σ_{j<b} R_j).
    perm: int [S, R] per-sample concat row → original query (0 on pad rows).
    inv_perm: int [S, Q] original query → per-sample concat row.
    row_valid: bool [S, R].
    """

    buckets: Tuple[PaddedGraph, ...]
    tgraph: Optional[TransposeGraph]
    perm: np.ndarray
    inv_perm: np.ndarray
    row_valid: np.ndarray

    @property
    def num_queries(self) -> int:
        return self.inv_perm.shape[-1]

    @property
    def bucket_rows(self) -> Tuple[int, ...]:
        return tuple(g.indices.shape[-2] for g in self.buckets)

    @property
    def bucket_ks(self) -> Tuple[int, ...]:
        return tuple(g.indices.shape[-1] for g in self.buckets)


def _stacked_bucket_layout(graph: PaddedGraph, tile: int, max_buckets: int,
                           launch_penalty_rows: int, min_gain: float, min_k: int):
    """The decision of :func:`bucketize_graphs_stacked`: (the kept bucket K
    values, their row counts, each query's bucket [S, Q]), or None."""
    if graph.indices.ndim != 3 or graph.indices.shape[-1] < min_k:
        return None
    s, q, k = graph.indices.shape
    deg = graph.mask.sum(-1).astype(np.int64)                     # [S, Q]
    ks = _choose_bucket_ks(deg.reshape(-1), k, max_buckets, tile,
                           launch_penalty_rows)
    bid = np.searchsorted(np.asarray(ks), np.maximum(deg, 1))     # [S, Q]
    counts = np.stack([(bid == b).sum(axis=1) for b in range(len(ks))],
                      axis=0)                                     # [nb, S]
    rs = [int(-(-max(int(c.max()), 0) // tile) * tile) if c.max() else 0
          for c in counts]
    keep = [b for b in range(len(ks)) if rs[b] > 0]
    ks = [ks[b] for b in keep]
    rs = [rs[b] for b in keep]
    bucketed_rows = sum(r * kk for r, kk in zip(rs, ks))
    if bucketed_rows == 0 or q * k < min_gain * bucketed_rows:
        return None
    return ks, rs, np.searchsorted(np.asarray(ks), np.maximum(deg, 1))


def bucketize_graphs_stacked(graph: PaddedGraph, num_sources: int,
                             with_transpose: bool = True, tile: int = 8,
                             max_buckets: int = 4,
                             launch_penalty_rows: int = 256,
                             min_gain: float = 1.15,
                             min_k: int = 12) -> Optional[BatchedBucketedGraph]:
    """Degree-bucket a stacked per-sample graph [S, Q, K].

    The bucket K values come from the pooled degree distribution of all
    samples; per-sample bucket row counts are padded to the maximum over
    samples (rounded to ``tile``), so every sample shares the layout.
    Returns None when the padded-row win does not clear ``min_gain`` or
    K < ``min_k``. ``num_sources`` is the per-sample source-set size.
    The decision and the layout are the JAX package's."""
    layout = _stacked_bucket_layout(graph, tile, max_buckets, launch_penalty_rows,
                                    min_gain, min_k)
    if layout is None:
        return None
    ks, rs, bid = layout
    s, q, _ = graph.indices.shape

    r_total = sum(rs)
    buckets = [(np.zeros((s, r, kk), dtype=np.int32),
                np.zeros((s, r, kk), dtype=bool)) for r, kk in zip(rs, ks)]
    perm = np.zeros((s, r_total), dtype=np.int32)
    inv_perm = np.zeros((s, q), dtype=np.int32)
    row_valid = np.zeros((s, r_total), dtype=bool)
    r_base = np.concatenate([[0], np.cumsum(rs)]).astype(np.int64)

    for i in range(s):
        order = np.argsort(bid[i], kind="stable")
        for b in range(len(ks)):
            rows = order[bid[i][order] == b]
            n = rows.shape[0]
            if n == 0:
                continue
            idx_b, msk_b = buckets[b]
            kb = ks[b]
            idx_b[i, :n] = graph.indices[i][rows, :kb]
            msk_b[i, :n] = graph.mask[i][rows, :kb]
            base = int(r_base[b])
            inv_perm[i, rows] = base + np.arange(n, dtype=np.int32)
            perm[i, base:base + n] = rows
            row_valid[i, base:base + n] = True

    bucket_graphs = tuple(PaddedGraph(idx, msk) for idx, msk in buckets)
    tg = None
    if with_transpose:
        tg = stack_tgraphs([
            transpose_bucket_edges(
                [PaddedGraph(g.indices[i], g.mask[i]) for g in bucket_graphs],
                num_sources)
            for i in range(s)])
    return BatchedBucketedGraph(buckets=bucket_graphs, tgraph=tg, perm=perm,
                                inv_perm=inv_perm, row_valid=row_valid)


def _array_to_device(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a).to(device)
    if np.issubdtype(a.dtype, np.integer):
        # torch indexes with int64; the values are the NumPy builder's.
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(a).to(device)


def graph_to_device(graph, device):
    """The same graph container (PaddedGraph, TransposeGraph,
    GroupedTransposeGraph, BucketedGraph, BatchedBucketedGraph, or a tuple
    of them) with every
    array a torch tensor on ``device``; None passes through."""
    if graph is None:
        return None
    if isinstance(graph, (np.ndarray, np.generic)):
        return _array_to_device(graph, device)
    if isinstance(graph, tuple):
        parts = [graph_to_device(g, device) for g in graph]
        return type(graph)(*parts) if hasattr(graph, "_fields") else tuple(parts)
    if isinstance(graph, torch.Tensor):
        return graph.to(device)
    raise TypeError(f"cannot move {type(graph).__name__} to a device")


def bucket_width(graph: PaddedGraph, min_k: int = 12) -> int:
    """The K of the widest degree bucket that :func:`bucketize_graph` (a
    [Q, K] graph) or :func:`bucketize_graphs_stacked` ([S, Q, K]) makes of
    ``graph`` at their other defaults, or its K where it stays dense: the
    width of edge drop's draw over the graph (``ops/edge_drop.py``), which a
    rank of spatial parallelism takes from the uncut graph."""
    if graph.indices.ndim == 2:
        layout = _bucket_layout(graph, 128, 4, 1024, 1.15, min_k)
        if layout is None:
            return graph.k
        ks, bid = layout
        return max(kb for b, kb in enumerate(ks) if (bid == b).any())
    layout = _stacked_bucket_layout(graph, 8, 4, 256, 1.15, min_k)
    return graph.k if layout is None else max(layout[0])
