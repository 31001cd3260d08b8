"""Gather-multiply-reduce: the AGNO apply primitive, forward.

Computes  out[b, q, c] = Σ_k coef[q, k, c] · f[b, idx[q, k], c]
(padded edges already carry coef == 0), the counterpart of the fx routes of
``gaot_tpu/ops/gather_apply.py``. The neighbour rows are gathered K-major
as whole [B·C] rows of the node-leading features (``bulk_gather``, an
``index_select``), then reduced over k by the multiply-reduce kernel
(``ops/cuda/multiply_reduce.py``). The backward (transpose-graph gathers,
never a scatter) comes with the training step; the kernel wrappers refuse
to run on the card where a gradient would be needed.
"""
from __future__ import annotations

import torch

from .cuda.multiply_reduce import multiply_reduce_k


def bulk_gather(f2d: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Leading-axis row gather: f2d [N, W], indices [...] → [..., W]."""
    rows = f2d.index_select(0, indices.reshape(-1))
    return rows.view(*indices.shape, f2d.shape[-1])


def _forward(coef: torch.Tensor, f: torch.Tensor,
             indices: torch.Tensor) -> torch.Tensor:
    """The plain gather-multiply-reduce (no transpose graph)."""
    if f.dim() == 2:
        return (coef * f[indices]).sum(-2)
    c = coef if coef.dim() == 4 else coef.unsqueeze(0)
    return (c * f[:, indices, :]).sum(-2)


def gather_multiply_reduce_nbc(coef: torch.Tensor, f: torch.Tensor,
                               indices: torch.Tensor) -> torch.Tensor:
    """coef [Q, K, C] shared over the batch; f [N, B, C] node-leading.
    Returns [Q, B, C]."""
    q, k, c = coef.shape
    n, b, _ = f.shape
    gath = bulk_gather(f.reshape(n, b * c), indices.t())          # [K, Q, W]
    return multiply_reduce_k(coef.transpose(0, 1), gath, b).view(q, b, c)


def bucketed_gather_multiply_reduce(coefs, f: torch.Tensor,
                                    indices) -> torch.Tensor:
    """Per-bucket gather-multiply-reduce, node-leading. coefs: per-bucket
    [Qb, Kb, C]; f: [N, B, C]; indices: per-bucket [Qb, Kb]. Returns
    [R, B, C] with R = Σ Qb, in bucket-concatenated row order."""
    n, b, c = f.shape
    f2d = f.reshape(n, b * c)
    outs = [multiply_reduce_k(coef.transpose(0, 1), bulk_gather(f2d, idx.t()), b)
            for coef, idx in zip(coefs, indices)]
    return torch.cat(outs, 0).view(-1, b, c)


def apply_bucketed_graph_transform(coefs, f: torch.Tensor, bg) -> torch.Tensor:
    """coefs: per-bucket [Qb, Kb, C]; f: [B, N, C] (fx batched, shared
    coefficients); bg: BucketedGraph. Returns [B, R, C] in
    bucket-concatenated row order."""
    if f.dim() != 3:
        raise NotImplementedError("the vx-flattened bucketed layout is not ported")
    out = bucketed_gather_multiply_reduce(
        coefs, f.transpose(0, 1).contiguous(), [g.indices for g in bg.buckets])
    return out.transpose(0, 1)


def unpermute_rows(x_cat: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """Rows back to original query order: x_cat [..., R, C] → [..., Q, C]."""
    return x_cat.index_select(-2, inv_perm)


def apply_graph_transform(coef: torch.Tensor, f: torch.Tensor, graph,
                          tgraph=None) -> torch.Tensor:
    """No transpose graph → the plain path; f [B, N, C] with shared coef
    [Q, K, C] → the node-leading bulk-gather route. Returns [B, Q, C]."""
    if tgraph is None:
        return _forward(coef, f, graph.indices)
    if f.dim() == 3 and coef.dim() == 3:
        out = gather_multiply_reduce_nbc(coef, f.transpose(0, 1).contiguous(),
                                         graph.indices)
        return out.transpose(0, 1)
    raise NotImplementedError("the vx-flattened transpose-graph route is not ported")
