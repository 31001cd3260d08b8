"""Gather-multiply-reduce: the AGNO apply primitive, forward and backward.

Computes  out[b, q, c] = Σ_k coef[q, k, c] · f[b, idx[q, k], c]
(padded edges already carry coef == 0), the counterpart of the fx routes of
``gaot_tpu/ops/gather_apply.py``. The node-leading features are read as
whole [B·C] rows by index inside the multiply-reduce kernel
(``ops/cuda/multiply_reduce.py``); no gathered copy of them is made.

The gradients are ``torch.autograd.Function``s whose backward gathers and
never scatters, as the JAX package's custom VJPs do: d_coef reduces the rows
of f, read by the forward's indices, against dout
(``gather_multiply_reduce_b``), and d_f reduces the dout rows and the
per-edge coefficients, both read through the transpose graph, with
``gather_multiply_reduce_k`` (masked slots read nothing).
"""
from __future__ import annotations

import torch

from .cuda.multiply_reduce import gather_multiply_reduce_b, gather_multiply_reduce_k
from .padding import GroupedTransposeGraph


def _forward(coef: torch.Tensor, f: torch.Tensor,
             indices: torch.Tensor) -> torch.Tensor:
    """The plain gather-multiply-reduce (no transpose graph)."""
    if f.dim() == 2:
        return (coef * f[indices]).sum(-2)
    c = coef if coef.dim() == 4 else coef.unsqueeze(0)
    return (c * f[:, indices, :]).sum(-2)


def _transpose_df(coef_flat: torch.Tensor, dout2: torch.Tensor,
                  edge_pos: torch.Tensor, tquery: torch.Tensor,
                  tmask: torch.Tensor, b: int, **out) -> torch.Tensor:
    """d_f rows of one transpose graph [N, Kt]: Σ_j coef_flat[edge_pos[n, j]]
    · dout2[tquery[n, j]] over the unmasked j. Returns [N, b·C], or writes
    them into ``out`` at ``row_map``."""
    return gather_multiply_reduce_k(dout2, tquery, coef_flat, b, coef_idx=edge_pos,
                                    mask=tmask, **out)


class _GatherMultiplyReduceNBC(torch.autograd.Function):
    """After ``gather_multiply_reduce_nbc`` (``_nbc_fwd`` / ``_nbc_bwd``).
    The forward saves f, the coefficients and the graph, not gathered rows:
    d_coef reads the rows of f by index again."""

    @staticmethod
    def forward(ctx, coef, f, indices, edge_pos, tquery, tmask):
        q, k, c = coef.shape
        n, b, _ = f.shape
        ctx.save_for_backward(coef, f, indices, edge_pos, tquery, tmask)
        return gather_multiply_reduce_k(f.reshape(n, b * c), indices, coef,
                                        b).view(q, b, c)

    @staticmethod
    def backward(ctx, dout):
        coef, f, indices, edge_pos, tquery, tmask = ctx.saved_tensors
        q, _, c = coef.shape
        n, b, _ = f.shape
        # The cotangent often arrives in fp32; both gradients go back in the
        # feature/parameter dtypes, so it is read in the feature dtype.
        dout2 = dout.to(f.dtype).reshape(q, b * c).contiguous()
        d_coef = d_f = None
        if ctx.needs_input_grad[0]:
            d_coef = gather_multiply_reduce_b(f.reshape(n, b * c), indices, dout2,
                                              b).to(coef.dtype)
        if ctx.needs_input_grad[1]:
            d_f = _transpose_df(coef.reshape(-1, c).to(f.dtype), dout2, edge_pos,
                                tquery, tmask, b)
            d_f = d_f.view(tmask.shape[0], b, c)
        return d_coef, d_f, None, None, None, None


def gather_multiply_reduce_nbc(coef: torch.Tensor, f: torch.Tensor,
                               indices: torch.Tensor, edge_pos: torch.Tensor,
                               tquery: torch.Tensor,
                               tmask: torch.Tensor) -> torch.Tensor:
    """coef [Q, K, C] shared over the batch; f [N, B, C] node-leading;
    indices [Q, K]; the transpose graph (edge_pos, tquery, tmask) [N, Kt].
    Returns [Q, B, C]."""
    return _GatherMultiplyReduceNBC.apply(coef, f, indices, edge_pos, tquery,
                                          tmask)


class _GatherMultiplyReduce(torch.autograd.Function):
    """After the batched branch of ``gather_multiply_reduce`` (``_fwd`` /
    ``_bwd``) with a per-sample coef [B, Q, K, C] (the nonlinear
    transforms). Plain PyTorch, as the JAX package leaves this branch to
    XLA; the backward gathers through the transpose graph and never
    scatters."""

    @staticmethod
    def forward(ctx, coef, f, indices, edge_pos, tquery, tmask):
        ctx.save_for_backward(coef, f, indices, edge_pos, tquery, tmask)
        return _forward(coef, f, indices)

    @staticmethod
    def backward(ctx, dout):
        coef, f, indices, edge_pos, tquery, tmask = ctx.saved_tensors
        b, _, _, c = coef.shape
        d_coef = dout[:, :, None, :] * f[:, indices, :]           # [B, Q, K, C]
        cg = coef.reshape(b, -1, c)[:, edge_pos, :]               # [B, N, Kt, C]
        dg = dout[:, tquery, :]                                   # [B, N, Kt, C]
        d_f = torch.where(tmask[None, :, :, None], cg * dg, 0).sum(-2)
        return (d_coef.to(coef.dtype), d_f.to(f.dtype), None, None, None, None)


def gather_multiply_reduce(coef: torch.Tensor, f: torch.Tensor,
                           indices: torch.Tensor, edge_pos: torch.Tensor,
                           tquery: torch.Tensor,
                           tmask: torch.Tensor) -> torch.Tensor:
    """coef [B, Q, K, C] per sample; f [B, N, C]; indices [Q, K]; the
    transpose graph (edge_pos, tquery, tmask) [N, Kt]. Returns [B, Q, C]."""
    return _GatherMultiplyReduce.apply(coef, f, indices, edge_pos, tquery, tmask)


class _BucketedGatherMultiplyReduce(torch.autograd.Function):
    """After ``bucketed_gather_multiply_reduce`` (``_bucketed_fwd`` /
    ``_bucketed_bwd`` and the fx branch of ``_bucketed_df``). The per-bucket
    coefs come last, one tensor argument each, so each gets its gradient.
    Each bucket's reduce writes its rows straight into the one output; the
    forward saves f, the coefficients and the indices."""

    @staticmethod
    def forward(ctx, f, indices, tgraph, *coefs):
        if tgraph is None and ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "the gradient of f needs the transpose graphs "
                "(magno.use_transpose_backward)")
        n, b, c = f.shape
        f2d = f.reshape(n, b * c)
        out = f2d.new_empty((sum(cf.shape[0] for cf in coefs), b * c))
        off = 0
        for coef, idx in zip(coefs, indices):
            qb = coef.shape[0]
            gather_multiply_reduce_k(f2d, idx, coef, b, out=out[off:off + qb])
            off += qb
        ctx.save_for_backward(f, *coefs, *indices)
        ctx.tgraph = tgraph
        return out.view(-1, b, c)

    @staticmethod
    def backward(ctx, dout):
        f, *saved = ctx.saved_tensors
        nb = len(saved) // 2
        coefs, indices = saved[:nb], saved[nb:]
        n, b, c = f.shape
        f2d = f.reshape(n, b * c)
        dout2 = dout.to(f.dtype).reshape(-1, b * c).contiguous()
        d_coefs, off = [], 0
        for i, (coef, idx) in enumerate(zip(coefs, indices)):
            qb = coef.shape[0]
            d_coefs.append(
                gather_multiply_reduce_b(f2d, idx, dout2[off:off + qb], b)
                .to(coef.dtype) if ctx.needs_input_grad[3 + i] else None)
            off += qb
        d_f = None
        if ctx.needs_input_grad[0]:
            coef_flat = torch.cat([cf.reshape(-1, c) for cf in coefs]).to(f.dtype)
            d_f = _bucketed_df(coef_flat, dout2, ctx.tgraph, b).view(n, b, c)
        return (d_f, None, None, *d_coefs)


def grouped_row_nodes(tgraph: GroupedTransposeGraph) -> torch.Tensor:
    """The node of each row of the concatenated in-degree groups (of the
    first sample): the inverse of ``inv_perm[0]``."""
    inv = tgraph.inv_perm[0]
    perm = torch.empty_like(inv)
    perm[inv] = torch.arange(inv.shape[0], dtype=inv.dtype, device=inv.device)
    return perm


def _bucketed_df(coef_flat: torch.Tensor, dout2: torch.Tensor, tgraph,
                 b: int) -> torch.Tensor:
    """d_f [N, b·C] over the combined transpose graph of the buckets: one
    pass per in-degree group, each writing its rows straight to node order
    (grouped), or one pass over the flat transpose graph."""
    if not isinstance(tgraph, GroupedTransposeGraph):
        return _transpose_df(coef_flat, dout2, tgraph.edge_pos, tgraph.query,
                             tgraph.mask, b)
    perm = grouped_row_nodes(tgraph)
    out = dout2.new_empty((perm.shape[0], dout2.shape[1]))
    off = 0
    for g in tgraph.groups:
        rows = g.mask.shape[1]
        _transpose_df(coef_flat, dout2, g.edge_pos[0], g.query[0], g.mask[0], b,
                      row_map=perm[off:off + rows], out=out)
        off += rows
    return out


def bucketed_gather_multiply_reduce(coefs, f: torch.Tensor, indices,
                                    tgraph) -> torch.Tensor:
    """Per-bucket gather-multiply-reduce, node-leading. coefs: per-bucket
    [Qb, Kb, C]; f: [N, B, C]; indices: per-bucket [Qb, Kb]; tgraph: the
    combined transpose graph of the buckets (grouped by in-degree, or
    flat). Returns [R, B, C] with R = Σ Qb, in bucket-concatenated row
    order."""
    return _BucketedGatherMultiplyReduce.apply(f, tuple(indices), tgraph,
                                               *coefs)


def apply_bucketed_graph_transform(coefs, f: torch.Tensor, bg) -> torch.Tensor:
    """coefs: per-bucket [Qb, Kb, C]; f: [B, N, C] (fx batched, shared
    coefficients); bg: BucketedGraph with its combined tgraph. Returns
    [B, R, C] in bucket-concatenated row order."""
    if f.dim() != 3:
        raise NotImplementedError("the vx-flattened bucketed layout is not ported")
    out = bucketed_gather_multiply_reduce(
        coefs, f.transpose(0, 1).contiguous(), [g.indices for g in bg.buckets],
        bg.tgraph)
    return out.transpose(0, 1)


class _UnpermuteRows(torch.autograd.Function):
    """After ``unpermute_rows``: inv_perm is injective, so the backward is
    the masked gather by ``perm``, not the scatter of a gather's autograd."""

    @staticmethod
    def forward(ctx, x_cat, inv_perm, perm, row_valid):
        ctx.save_for_backward(perm, row_valid)
        return x_cat.index_select(-2, inv_perm)

    @staticmethod
    def backward(ctx, g):
        perm, row_valid = ctx.saved_tensors
        return (torch.where(row_valid[:, None], g.index_select(-2, perm), 0),
                None, None, None)


def unpermute_rows(x_cat: torch.Tensor, inv_perm: torch.Tensor,
                   perm: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Rows back to original query order: x_cat [..., R, C] → [..., Q, C].
    inv_perm [Q]: original → concat position; perm [R]: concat → original
    (0 on pad rows); row_valid [R]."""
    return _UnpermuteRows.apply(x_cat, inv_perm, perm, row_valid)


def apply_graph_transform(coef: torch.Tensor, f: torch.Tensor, graph,
                          tgraph=None) -> torch.Tensor:
    """No transpose graph → the plain path (autograd's backward); f
    [B, N, C] with shared coef [Q, K, C] → the node-leading bulk-gather
    route with the transpose-graph backward; f [B, N, C] with a per-sample
    coef [B, Q, K, C] → :func:`gather_multiply_reduce`. Returns [B, Q, C]."""
    if tgraph is None:
        return _forward(coef, f, graph.indices)
    if f.dim() == 3 and coef.dim() == 3:
        out = gather_multiply_reduce_nbc(coef, f.transpose(0, 1).contiguous(),
                                         graph.indices, tgraph.edge_pos,
                                         tgraph.query, tgraph.mask)
        return out.transpose(0, 1)
    if f.dim() == 3 and coef.dim() == 4:
        return gather_multiply_reduce(coef, f, graph.indices, tgraph.edge_pos,
                                      tgraph.query, tgraph.mask)
    raise NotImplementedError("the vx-flattened transpose-graph route is not ported")
