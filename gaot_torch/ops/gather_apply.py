"""Gather-multiply-reduce: the AGNO apply primitive, forward and backward.

Computes  out[b, q, c] = Σ_k coef[q, k, c] · f[b, idx[q, k], c]
(padded edges already carry coef == 0), the counterpart of the fx routes of
``gaot_tpu/ops/gather_apply.py``. The neighbour rows are gathered K-major
as whole [B·C] rows of the node-leading features (``bulk_gather``, an
``index_select``), then reduced over k by the multiply-reduce kernel
(``ops/cuda/multiply_reduce.py``).

The gradients are ``torch.autograd.Function``s whose backward gathers and
never scatters, as the JAX package's custom VJPs do: d_coef reduces the
gathered rows the forward saved against dout (``multiply_reduce_b``), and
d_f gathers the per-edge coefficients and the dout rows through the
transpose graph and reduces them with ``multiply_reduce_k``.
"""
from __future__ import annotations

import torch

from .cuda.multiply_reduce import multiply_reduce_b, multiply_reduce_k
from .padding import GroupedTransposeGraph


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


def _transpose_df(coef_flat: torch.Tensor, dout2: torch.Tensor,
                  edge_pos: torch.Tensor, tquery: torch.Tensor,
                  tmask: torch.Tensor, b: int) -> torch.Tensor:
    """d_f rows of one transpose graph [N, Kt]: Σ_j coef_flat[edge_pos[n, j]]
    · dout2[tquery[n, j]] over the unmasked j. Returns [N, b·C]."""
    cg = torch.where(tmask.t()[..., None], bulk_gather(coef_flat, edge_pos.t()),
                     0)                                           # [Kt, N, C]
    dg = bulk_gather(dout2, tquery.t())                           # [Kt, N, W]
    return multiply_reduce_k(cg, dg, b)


class _GatherMultiplyReduceNBC(torch.autograd.Function):
    """After ``gather_multiply_reduce_nbc`` (``_nbc_fwd`` / ``_nbc_bwd``)."""

    @staticmethod
    def forward(ctx, coef, f, indices, edge_pos, tquery, tmask):
        q, k, c = coef.shape
        n, b, _ = f.shape
        gath = bulk_gather(f.reshape(n, b * c), indices.t())       # [K, Q, W]
        ctx.save_for_backward(coef, gath, edge_pos, tquery, tmask)
        return multiply_reduce_k(coef.transpose(0, 1), gath, b).view(q, b, c)

    @staticmethod
    def backward(ctx, dout):
        coef, gath, edge_pos, tquery, tmask = ctx.saved_tensors
        q, _, c = coef.shape
        b = dout.shape[1]
        f_dtype = gath.dtype
        # The cotangent often arrives in fp32; both gradients go back in the
        # feature/parameter dtypes, so it is gathered in the feature dtype.
        dout2 = dout.to(f_dtype).reshape(q, b * c).contiguous()
        d_coef = d_f = None
        if ctx.needs_input_grad[0]:
            d_coef = multiply_reduce_b(gath, dout2, b).transpose(0, 1).to(coef.dtype)
        if ctx.needs_input_grad[1]:
            d_f = _transpose_df(coef.reshape(-1, c).to(f_dtype), dout2, edge_pos,
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
    coefs come last, one tensor argument each, so each gets its gradient."""

    @staticmethod
    def forward(ctx, f, indices, tgraph, *coefs):
        if tgraph is None and ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "the gradient of f needs the transpose graphs "
                "(magno.use_transpose_backward)")
        n, b, c = f.shape
        f2d = f.reshape(n, b * c)
        outs, gaths = [], []
        for coef, idx in zip(coefs, indices):
            gath = bulk_gather(f2d, idx.t())                       # [Kb, Qb, W]
            gaths.append(gath)
            outs.append(multiply_reduce_k(coef.transpose(0, 1), gath, b))
        ctx.save_for_backward(*coefs, *gaths)
        ctx.tgraph, ctx.n = tgraph, n
        return torch.cat(outs, 0).view(-1, b, c)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        nb = len(saved) // 2
        coefs, gaths = saved[:nb], saved[nb:]
        c = coefs[0].shape[-1]
        b = dout.shape[1]
        f_dtype = gaths[0].dtype
        dout2 = dout.to(f_dtype).reshape(-1, b * c).contiguous()
        d_coefs, off = [], 0
        for i, (coef, gath) in enumerate(zip(coefs, gaths)):
            qb = coef.shape[0]
            d_coefs.append(
                multiply_reduce_b(gath, dout2[off:off + qb], b)
                .transpose(0, 1).to(coef.dtype)
                if ctx.needs_input_grad[3 + i] else None)
            off += qb
        d_f = None
        if ctx.needs_input_grad[0]:
            coef_flat = torch.cat([cf.reshape(-1, c) for cf in coefs]).to(f_dtype)
            d_f = _bucketed_df(coef_flat, dout2, ctx.tgraph, b).view(ctx.n, b, c)
        return (d_f, None, None, *d_coefs)


def _bucketed_df(coef_flat: torch.Tensor, dout2: torch.Tensor, tgraph,
                 b: int) -> torch.Tensor:
    """d_f [N, b·C] over the combined transpose graph of the buckets: one
    pass per in-degree group, then the rows back to node order (grouped), or
    one pass over the flat transpose graph."""
    if not isinstance(tgraph, GroupedTransposeGraph):
        return _transpose_df(coef_flat, dout2, tgraph.edge_pos, tgraph.query,
                             tgraph.mask, b)
    es, rows = coef_flat.shape[0], dout2.shape[0]
    parts = []
    for g in tgraph.groups:
        # Padded slots are clipped into range and masked: on the card an
        # out-of-range index is a device fault, not a zero.
        parts.append(_transpose_df(coef_flat, dout2, g.edge_pos[0].clamp(0, es - 1),
                                   g.query[0].clamp(0, rows - 1), g.mask[0], b))
    return torch.cat(parts, 0).index_select(0, tgraph.inv_perm[0])


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
