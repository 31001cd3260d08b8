"""Spatial (query) sharding over the model axis.

Counterpart of ``gaot_tpu/parallel/spatial.py``. The JAX package hints XLA
to shard the query axis over 'model' (``shard_queries`` at
``gaot_tpu/models/gaot.py:149, :182, :188`` and
``gaot_tpu/models/transformer.py:295``) and the partitioner writes the
collectives. Here they are written out. With ``setup.spatial_parallel``
each rank of the model axis:

- computes, in the encoder, only its contiguous range of latent queries:
  the latent grid is cut along its first axis in multiples of the patch
  size, so every patch stays on one rank, and the encoder graphs' rows are
  cut to that range (their degree buckets and transpose graphs are those of
  the cut graph);
- keeps its tokens through ``patch_linear``, the norms, QKV and the FFN; the
  absolute positions are sliced at the rank's offset; attention gathers Q,
  K and V (``comm.gather_along``), applies RoPE at the global token indices,
  runs the flash kernel at the full sequence and keeps its own rows;
- gathers the latent grid before the decoder and computes only its range of
  output queries (the decoder graphs' rows cut to it); the loss sums and
  counts are summed over the ranks, and every parameter's gradient, partial
  on each rank, is summed over the model axis.

On vx data (a mesh per sample) the output queries are each sample's padded
nodes, which the graph build puts in Morton order, so a rank's contiguous
range of them is a compact patch of every mesh; the stacked [S, Q, K]
graphs are cut along their query axis before they are bucketed
(``data/graph_builder.py``), and keep all their sources. The geometric
embedding standardizes each sample's features over the rows of every rank
(``models/gemb.py``). Edge drop draws what one process draws: the uncut
graph's uniforms, of which a rank keeps its rows (``ops/edge_drop.py``).

The transformer weights stay whole: tensor and sequence parallelism on one
axis (Megatron's sequence parallelism) is not ported. The numbers are the
one-process numbers either way; only the memory differs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import comm


class SpatialShard(NamedTuple):
    """This rank's ranges: latent queries, UViT tokens and output queries
    (``nodes``, of ``node_chunk`` rows a rank, the last rank's fewer where
    the count does not divide; on vx data each sample's padded nodes), and
    its part of the latent grid. ``widths``: the encoder's and the decoder's
    edge-drop draw width per scale, taken from the uncut graphs
    (``ops/padding.py::bucket_width``), so that a rank draws what one
    process draws (None: no edge drop)."""

    group: object
    count: int
    latent: Tuple[int, int]
    tokens: Tuple[int, int]
    nodes: Tuple[int, int]
    node_chunk: int
    num_nodes: int
    grid: Tuple[int, ...]
    widths: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None


def spatial_shard(grid_shape: Sequence[int], patch_size: int, num_nodes: int,
                  group, index: int, count: int) -> SpatialShard:
    """The ranges of rank ``index`` of ``count``: the latent grid cut along
    its first axis into ``count`` slabs, each a whole number of patches
    (else a ValueError), the nodes into ⌈num_nodes / count⌉ rows a rank."""
    first, rest = grid_shape[0], tuple(grid_shape[1:])
    if first % (count * patch_size):
        raise ValueError(
            f"spatial_parallel over {count} ranks cuts the latent grid {tuple(grid_shape)} "
            f"along its first axis in whole patches of {patch_size}: {first} must be a "
            f"multiple of {count * patch_size}")
    slab = first // count
    per_row = int(np.prod(rest, dtype=np.int64))
    tokens_per_row = per_row // patch_size ** len(rest)
    chunk = -(-num_nodes // count)
    return SpatialShard(
        group, count,
        latent=(index * slab * per_row, (index + 1) * slab * per_row),
        tokens=(index * slab // patch_size * tokens_per_row,
                (index + 1) * slab // patch_size * tokens_per_row),
        nodes=(min(index * chunk, num_nodes), min((index + 1) * chunk, num_nodes)),
        node_chunk=chunk, num_nodes=num_nodes, grid=(slab, *rest))


def cut_rows(graph, lo: int, hi: int):
    """A host PaddedGraph's query rows [lo, hi): of its one graph [Q, K]
    (fx), or of each sample's graph of a stack [S, Q, K] (vx)."""
    return graph._replace(indices=graph.indices[..., lo:hi, :],
                          mask=graph.mask[..., lo:hi, :])


def gather_nodes(x: torch.Tensor, shard: SpatialShard, dim: int) -> torch.Tensor:
    """The full output of the ranks' node ranges along ``dim`` (evaluation:
    no gradient): each range padded to ``node_chunk`` rows, gathered, the
    padding dropped."""
    if shard is None or shard.count == 1:
        return x
    dim = dim % x.dim()
    pad = shard.node_chunk - x.shape[dim]
    if pad:
        x = torch.cat([x, x.new_zeros(*x.shape[:dim], pad, *x.shape[dim + 1:])], dim)
    # Only the last ranks' chunks are short: the padding is at the end.
    return comm.all_gather(x.contiguous(), shard.group, dim).narrow(
        dim, 0, shard.num_nodes)


def sum_grads(params, group) -> None:
    """Sum the parameters' gradients over ``group`` (one all-reduce of all
    of them flattened)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or group is None:
        return
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
