"""Edge drop (neighbour sampling) as a dropout of the padded K axis's mask.

Counterpart of ``gaot_tpu/ops/edge_drop.py``, a training-only
regularisation:

- ``ratio``: each edge kept on its own with probability ``sample_ratio``;
- ``max_neighbors``: each query keeps a uniformly random subset of at most
  ``max_neighbors`` of its edges: a uniform score in [0, 1) for each valid
  edge and −1 for each padding slot, the slots scoring at least the row's
  ``max_neighbors``-th largest score kept (ties keep more; a row with fewer
  valid edges keeps them all).

The draw comes from a ``torch.Generator`` on the mask's device and the mask
stays on the device: no value is read back to the host. A new contiguous
bool mask is returned, since the multiply-reduce kernel reads masks as
bytes; the mask given is never written, so graphs placed once on the device
(fx, and the vx layout) stay as they were built.

A graph's draw (:func:`bucket_uniforms`) does not depend on how its rows are
laid out: the uniforms are drawn once, in query order, over the dense
[rows, width] layout of the uncut graph (every sample's rows, sample-major,
for a vx graph), and each degree bucket reads its rows' slots through its
row ids (``perm``; a bucket row's valid slots are the first slots of its
query's dense row). So a rank of spatial parallelism, whose graph holds a
range of the queries in buckets of its own, draws the whole tensor (its
generator moves as one process's) and keeps its range; a data-parallel
rank draws the global batch's samples and keeps its own
(:class:`~gaot_torch.ops.draws.BatchShare`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .draws import Draws, uniform
from .gather_apply import FlatGraph
from .padding import BucketedGraph


def _draws(strategy: str, width: int, max_neighbors: Optional[int],
           sample_ratio: Optional[float]) -> bool:
    """Whether the strategy thins a graph whose rows are ``width`` wide."""
    if strategy == "ratio":
        return sample_ratio is not None and sample_ratio < 1.0
    if strategy == "max_neighbors":
        return max_neighbors is not None and max_neighbors < width
    raise ValueError(f"Unknown sampling strategy: {strategy}")


def _thin(mask: torch.Tensor, u: torch.Tensor, strategy: str,
          max_neighbors: Optional[int], sample_ratio: Optional[float]) -> torch.Tensor:
    """``mask`` thinned by the uniforms ``u`` (one per slot)."""
    if strategy == "ratio":
        return mask & (u < sample_ratio)
    scores = torch.where(mask, u, -1.0)
    kth = torch.topk(scores, max_neighbors, dim=-1, sorted=True).values[..., -1:]
    return mask & (scores >= kth)


def apply_edge_drop_mask(mask: torch.Tensor, generator: Optional[Draws],
                         strategy: Optional[str], max_neighbors: Optional[int] = None,
                         sample_ratio: Optional[float] = None) -> torch.Tensor:
    """The thinned neighbour mask of ``mask`` (bool [..., Q, K]), from
    uniforms drawn over the mask's own shape, or from those given as
    ``generator`` (a tensor of the mask's shape: :func:`bucket_uniforms`).
    Without a generator or a strategy, with a ratio of 1 or more, or where
    K is at most ``max_neighbors``, nothing is drawn and ``mask`` itself
    returns."""
    if generator is None or strategy is None or not _draws(
            strategy, mask.shape[-1], max_neighbors, sample_ratio):
        return mask
    return _thin(mask, uniform(mask.shape, generator, mask.device), strategy,
                 max_neighbors, sample_ratio)


def bucket_uniforms(graph, generator: Optional[Draws], strategy: Optional[str],
                    max_neighbors: Optional[int] = None,
                    sample_ratio: Optional[float] = None,
                    layout: Optional[Tuple[int, int, int]] = None) -> Optional[list]:
    """The uniforms of edge drop over ``graph`` (a PaddedGraph [Q, K] or a
    BucketedGraph: fx, one graph for the batch; a FlatGraph: vx, its
    samples' rows): per bucket (one for a PaddedGraph) a [rows, K] tensor
    of its slots' draws, to thin its mask with through
    :func:`apply_edge_drop_mask`, or None for a bucket the strategy leaves
    as it is (at most ``max_neighbors`` wide); None where nothing is drawn
    (no generator or strategy, a ratio of 1 or more, a width at most
    ``max_neighbors``).

    ``layout`` (rows, offset, width): each sample's uncut graph has ``rows``
    query rows, of which this graph holds those from ``offset`` on, and the
    draw is ``width`` slots wide (the widest bucket of the uncut layout,
    :func:`~gaot_torch.ops.padding.bucket_width`); None: the graph's own
    queries, 0 and its widest bucket."""
    if generator is None or strategy is None:
        return None
    bucketed = isinstance(graph, (BucketedGraph, FlatGraph))
    buckets = graph.buckets if bucketed else (graph,)
    samples = graph.num_samples if isinstance(graph, FlatGraph) else None
    s = samples or 1
    if isinstance(graph, FlatGraph):
        queries = graph.rows if graph.inv_perm is None else graph.inv_perm.shape[0] // s
    elif bucketed:
        queries = graph.inv_perm.shape[-1]
    else:
        queries = graph.mask.shape[0]
    rows, offset, width = layout or (queries, 0, max(b.mask.shape[-1] for b in buckets))
    if not _draws(strategy, width, max_neighbors, sample_ratio):
        return None
    u = uniform((s * rows, width), generator, buckets[0].mask.device, samples)
    if (rows, offset) != (queries, 0):
        u = u.view(s, rows, width)[:, offset:offset + queries].reshape(s * queries, width)
    perm = graph.perm if bucketed else None
    out, base = [], 0
    for b in buckets:
        r, k = b.mask.shape[0] // s, b.mask.shape[-1]
        if strategy == "max_neighbors" and k <= max_neighbors:
            out.append(None)
        else:
            uk = u[:, :k]
            if perm is not None:
                uk = uk.index_select(0, perm.view(s, -1)[:, base:base + r].reshape(-1))
            if k > width:
                # Slots past the uncut graph's widest bucket are padding in
                # every row.
                uk = F.pad(uk, (0, k - width))
            out.append(uk)
        base += r
    return out
