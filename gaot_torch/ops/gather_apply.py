"""Gather-multiply-reduce: the AGNO apply primitive, forward and backward.

Computes  out[b, q, c] = Σ_k coef[q, k, c] · f[b, idx[q, k], c]
(padded edges already carry coef == 0), the counterpart of
``gaot_tpu/ops/gather_apply.py``. One autograd Function,
:func:`flat_gather_multiply_reduce`, serves fx and vx: the features are
rows [n, b·C] read by index inside the multiply-reduce kernel
(``ops/cuda/multiply_reduce.py``), no gathered copy of them is made, and
the graph is a :class:`FlatGraph` of one or more degree buckets over S
samples, one kernel launch per bucket over every sample.

- fx: one sample (S = 1); the batch rides in the row, b = B
  (node-leading f [N, B·C]), the coefficients are shared by the batch;
- vx (a mesh per sample): the batch's graphs flattened over the batch,
  f [B·N, C], b = 1, a per-edge coefficient.

The gradients gather and never scatter, as the JAX package's custom VJPs
do: d_coef reduces the rows of f, read by the forward's indices, against
dout (``gather_multiply_reduce_b``), and d_f reduces the dout rows and the
per-edge coefficients, both read through the transpose graph, with
``gather_multiply_reduce_k`` (masked slots read nothing), one launch per
in-degree group over every sample, each writing node order through its row
map.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .cuda.multiply_reduce import gather_multiply_reduce_b, gather_multiply_reduce_k
from .padding import GroupedTransposeGraph, PaddedGraph, TransposeGraph


def _forward(coef: torch.Tensor, f: torch.Tensor,
             indices: torch.Tensor) -> torch.Tensor:
    """The plain gather-multiply-reduce (no transpose graph)."""
    if f.dim() == 2:
        return (coef * f[indices]).sum(-2)
    c = coef if coef.dim() == 4 else coef.unsqueeze(0)
    return (c * f[:, indices, :]).sum(-2)


class FlatGraph(NamedTuple):
    """The graph of one AGNO call over S samples, sample-major: sample s's
    rows follow sample s − 1's.

    buckets: per degree bucket (one for a dense graph) [S·R_j, K_j], rows
        s·R_j + r, indices s·n_src + the sample's own source id; the mask
        None where every slot is read (fx: padded edges carry a zero
        coefficient);
    row_maps: per bucket [S·R_j], the row s·R + Σ_{i<j} R_i + r of the
        bucket-concatenated output [S·R, ·], or None where the bucket's
        rows already sit in place (S = 1, or one bucket);
    rows: R, a sample's rows (Σ R_j; the queries Q for a dense graph);
    perm: [S·R] s·Q + the original query of each row (s·Q on pad rows),
        or None (dense: rows are the queries);
    inv_perm: [S·Q] s·R + the row of each original query, or None;
    row_valid: [S·R] False on the buckets' pad rows, or None;
    tgraph: the transpose graph of the buckets: in-degree grouped and
        stacked per sample [S, ·, ·] with each sample's own edge ids
        r·K_j + k (after its bucket's base Σ_{i<j} R_i·K_i) and rows, or
        (fx) one flat TransposeGraph; None: no gradient of f;
    num_samples: S;
    iota: the ids 0, 1, ... (at least max(S, n_src) of them) on the
        graph's device, made once where the layout is placed (None: made
        when the gradient needs them).
    """

    buckets: Tuple[PaddedGraph, ...]
    row_maps: Tuple[Optional[torch.Tensor], ...]
    rows: int
    perm: Optional[torch.Tensor]
    inv_perm: Optional[torch.Tensor]
    row_valid: Optional[torch.Tensor]
    tgraph: object
    num_samples: int
    iota: Optional[torch.Tensor] = None


def _by_sample(t: torch.Tensor, slot: torch.Tensor, n: int) -> torch.Tensor:
    """t [S, ...] with s·n added to sample s's ids, flattened over S."""
    if t.shape[0] == 1:
        return t.reshape(-1, *t.shape[2:])
    slot = slot.view(-1, *[1] * (t.dim() - 1))
    return torch.add(t, slot, alpha=n).view(-1, *t.shape[2:])


def df_calls(fg: FlatGraph, edges: int):
    """The d_f calls of a flat graph, one per in-degree group over every
    sample: (query, edge_pos, mask [S·R_g, Kt_g], row_map [S·R_g] or None)
    in the flat spaces. Sample s's edge ids are offset by s·edges
    (``edges`` a sample's, Σ R_j·K_j), its rows by s·R, and each group row
    writes its node's row s·n_src + node through the row map. A flat
    transpose graph (fx) is one call, its rows in node order."""
    tg, s = fg.tgraph, fg.num_samples
    if not isinstance(tg, GroupedTransposeGraph):
        return [(tg.query, tg.edge_pos, tg.mask, None)]
    inv = tg.inv_perm                                        # [S, n_src]
    n_src = inv.shape[1]
    iota = (fg.iota if fg.iota is not None
            else torch.arange(max(s, n_src), dtype=inv.dtype, device=inv.device))
    slot = iota[:s]
    # The node at each grouped row of each sample (the inverse of inv_perm).
    nodes = torch.empty_like(inv).scatter_(1, inv.long(), iota[:n_src].expand(s, n_src))
    calls, base = [], 0
    for g in tg.groups:
        rg = g.mask.shape[1]
        calls.append((_by_sample(g.query, slot, fg.rows),
                      _by_sample(g.edge_pos, slot, edges),
                      g.mask.reshape(-1, g.mask.shape[2]),
                      _by_sample(nodes[:, base:base + rg], slot, n_src)))
        base += rg
    return calls


def _transpose_df(table: torch.Tensor, dout2: torch.Tensor, fg: FlatGraph,
                  n_out: int, b: int) -> torch.Tensor:
    """d_f [n_out, b·C]: Σ_j table[edge_pos[n, j]] · dout2[tquery[n, j]] over
    the unmasked j of every transpose-graph call."""
    calls = df_calls(fg, table.shape[0] // fg.num_samples)
    if calls[0][3] is None:
        tq, ep, mask, _ = calls[0]
        return gather_multiply_reduce_k(dout2, tq, table, b, coef_idx=ep, mask=mask)
    out = dout2.new_empty((n_out, dout2.shape[1]))
    for tq, ep, mask, rm in calls:
        gather_multiply_reduce_k(dout2, tq, table, b, coef_idx=ep, mask=mask,
                                 row_map=rm, out=out)
    return out


class _FlatGatherMultiplyReduce(torch.autograd.Function):
    """After the AGNO apply routes of ``gaot_tpu/ops/gather_apply.py``
    (``gather_multiply_reduce_nbc``, ``bucketed_gather_multiply_reduce``
    and the vx routes ``gather_multiply_reduce_km``, ``gather_rows_tg``,
    ``gather_rows_bucketed_tg`` with the grouped scans): out[q] = Σ_k
    coef[q, k] · f[idx[q, k]] per bucket, each bucket writing its rows
    straight into the one output; d_coef from the same rows, d_f over the
    transpose graph. The forward saves f and the coefficients, not gathered
    rows. The coefficients are q-major [S·R_j, K_j, C] and come last, one
    tensor argument each, so each gets its gradient; the transpose graph's
    edge ids address their per-sample concatenation directly."""

    @staticmethod
    def forward(ctx, f, fg, b, *coefs):
        if fg.tgraph is None and ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "the gradient of f needs the transpose graphs "
                "(magno.use_transpose_backward)")
        s = fg.num_samples
        out = f.new_empty((s * fg.rows, f.shape[1]))
        base = 0
        for coef, g, rm in zip(coefs, fg.buckets, fg.row_maps):
            rj = g.indices.shape[0] // s
            gather_multiply_reduce_k(f, g.indices, coef, b, mask=g.mask, row_map=rm,
                                     out=out if rm is not None
                                     else out[s * base:s * (base + rj)])
            base += rj
        ctx.save_for_backward(f, *coefs)
        ctx.fg, ctx.b = fg, b
        return out

    @staticmethod
    def backward(ctx, dout):
        f, *coefs = ctx.saved_tensors
        fg, b = ctx.fg, ctx.b
        s, w = fg.num_samples, f.shape[1]
        c = w // b
        # The cotangent often arrives in fp32; both gradients go back in the
        # feature/parameter dtypes, so it is read in the feature dtype.
        dout2 = dout.to(f.dtype).contiguous()
        d3 = dout2.view(s, fg.rows, w)
        d_coefs, base = [], 0
        for i, (coef, g) in enumerate(zip(coefs, fg.buckets)):
            rj = g.indices.shape[0] // s
            if ctx.needs_input_grad[3 + i]:
                rows = d3[:, base:base + rj].reshape(s * rj, w)
                d_coefs.append(gather_multiply_reduce_b(f, g.indices, rows, b)
                               .to(coef.dtype))
            else:
                d_coefs.append(None)
            base += rj
        d_f = None
        if ctx.needs_input_grad[0]:
            parts = [cf.reshape(s, -1, c) for cf in coefs]
            table = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            d_f = _transpose_df(table.reshape(-1, c).to(f.dtype), dout2, fg,
                                f.shape[0], b)
        return (d_f, None, None, *d_coefs)


def flat_gather_multiply_reduce(coefs, f: torch.Tensor, fg: FlatGraph,
                                b: int = 1) -> torch.Tensor:
    """coefs: per-bucket [S·R_j, K_j, C] coefficients (masked edges zero);
    f: [n, b·C] rows; fg: the flat graph. Returns [S·R, b·C], the buckets'
    rows concatenated per sample."""
    return _FlatGatherMultiplyReduce.apply(f, fg, b, *coefs)


def _fx_graph(indices, tgraph) -> FlatGraph:
    """The FlatGraph of an fx call: one sample, unmasked buckets."""
    return FlatGraph(tuple(PaddedGraph(i, None) for i in indices),
                     (None,) * len(indices), sum(i.shape[0] for i in indices),
                     None, None, None, tgraph, 1)


def gather_multiply_reduce_nbc(coef: torch.Tensor, f: torch.Tensor,
                               indices: torch.Tensor, edge_pos: torch.Tensor,
                               tquery: torch.Tensor,
                               tmask: torch.Tensor) -> torch.Tensor:
    """coef [Q, K, C] shared over the batch; f [N, B, C] node-leading;
    indices [Q, K]; the transpose graph (edge_pos, tquery, tmask) [N, Kt].
    Returns [Q, B, C]."""
    n, b, c = f.shape
    fg = _fx_graph([indices], TransposeGraph(edge_pos, tquery, tmask))
    return flat_gather_multiply_reduce([coef], f.reshape(n, b * c), fg, b).view(-1, b, c)


def bucketed_gather_multiply_reduce(coefs, f: torch.Tensor, indices,
                                    tgraph) -> torch.Tensor:
    """Per-bucket gather-multiply-reduce, node-leading. coefs: per-bucket
    [Qb, Kb, C]; f: [N, B, C]; indices: per-bucket [Qb, Kb]; tgraph: the
    combined transpose graph of the buckets (grouped by in-degree, or
    flat). Returns [R, B, C] with R = Σ Qb, in bucket-concatenated row
    order."""
    n, b, c = f.shape
    return flat_gather_multiply_reduce(coefs, f.reshape(n, b * c),
                                       _fx_graph(indices, tgraph), b).view(-1, b, c)


def apply_bucketed_graph_transform(coefs, f: torch.Tensor, bg) -> torch.Tensor:
    """coefs: per-bucket [Qb, Kb, C]; f: [B, N, C] (fx batched, shared
    coefficients); bg: BucketedGraph with its combined tgraph. Returns
    [B, R, C] in bucket-concatenated row order."""
    out = bucketed_gather_multiply_reduce(
        coefs, f.transpose(0, 1).contiguous(), [g.indices for g in bg.buckets],
        bg.tgraph)
    return out.transpose(0, 1)


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


def apply_graph_transform(coef: torch.Tensor, f: torch.Tensor, graph,
                          tgraph=None) -> torch.Tensor:
    """No transpose graph → the plain path (autograd's backward); f
    [B, N, C] with shared coef [Q, K, C] → the node-leading route with the
    transpose-graph backward; f [B, N, C] with a per-sample coef
    [B, Q, K, C] → :func:`gather_multiply_reduce`. Returns [B, Q, C]."""
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
    raise NotImplementedError("a 2D f with per-sample coefficients (the flat q-major "
                              "route of nonlinear transforms on vx) is not ported "
                              "(ROADMAP §1)")


def _take_rows(x: torch.Tensor, idx: torch.Tensor, b: int,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[m] = x[idx[m]] (zeros where ``valid`` is False), x [n, b·C], read
    by index inside the multiply-reduce kernel with a coefficient of one:
    PyTorch's own row gather is the vectorized_gather_kernel the AGNO apply
    keeps off the device."""
    c = x.shape[1] // b
    ones = x.new_ones(c).expand(idx.shape[0], 1, c)
    return gather_multiply_reduce_k(x, idx[:, None], ones, b,
                                    mask=None if valid is None else valid[:, None])


class _PermuteRows(torch.autograd.Function):
    """After ``unpermute_rows``: inv_perm is injective, so the backward is
    the masked read by ``perm``, not the scatter of a gather's autograd."""

    @staticmethod
    def forward(ctx, x, inv_perm, perm, row_valid, b):
        ctx.save_for_backward(perm, row_valid)
        ctx.b = b
        return _take_rows(x, inv_perm, b)

    @staticmethod
    def backward(ctx, g):
        perm, row_valid = ctx.saved_tensors
        return (_take_rows(g.contiguous(), perm, ctx.b, row_valid),
                None, None, None, None)


def permute_rows(x: torch.Tensor, inv_perm: torch.Tensor, perm: torch.Tensor,
                 row_valid: torch.Tensor, b: int = 1) -> torch.Tensor:
    """Rows back to original query order: x [R, b·C] → [Q, b·C].
    inv_perm [Q]: original → concat position; perm [R]: concat → original
    (0 on pad rows); row_valid [R]."""
    return _PermuteRows.apply(x.contiguous(), inv_perm, perm, row_valid, b)


def unpermute_rows(x_cat: torch.Tensor, inv_perm: torch.Tensor,
                   perm: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """:func:`permute_rows` of a batch that shares its graph:
    x_cat [B, R, C] → [B, Q, C]."""
    b, r, c = x_cat.shape
    out = permute_rows(x_cat.transpose(0, 1).reshape(r, b * c), inv_perm, perm,
                       row_valid, b)
    return out.view(-1, b, c).transpose(0, 1)
