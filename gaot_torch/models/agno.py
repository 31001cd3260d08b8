"""Attentional Graph Neural Operator (AGNO) on padded neighborhoods.

Counterpart of ``gaot_tpu/models/agno.py``:

    out(x) = reduce_{y in A(x)} α(x,y) · k(x, y[, f(y)]) [· f(y)]

over a padded K-neighborhood A(x). In 'linear' modes the kernel depends only
on coordinates, so kernel values are computed once per graph and shared by
the whole batch; attention, quadrature/mean weights and the padding mask fold
into one per-edge scale cast to the kernel dtype, and one
gather-multiply-reduce applies the coefficient to the features, with or
without a transpose graph for its gradient. On a vx batch (a mesh per
sample, flattened over the batch) the linear coefficient is per edge, from
:meth:`AGNO._folded_coef` per degree bucket, and the nonlinear transforms
run the plain per-edge body (:meth:`AGNO._call_vx`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.gather_apply import (
    FlatGraph,
    apply_bucketed_graph_transform,
    apply_graph_transform,
    flat_gather_multiply_reduce,
    gather_rows,
)
from ..ops.padding import BucketedGraph
from ..ops.segment_ops import masked_mean, masked_softmax, masked_sum
from ..utils.routing import record_route
from .gemb import node_pos_encode
from .mlp import Dense, LinearChannelMLP

_TRANSFORMS = ("linear", "nonlinear", "linear_kernelonly", "nonlinear_kernelonly")


def _edge_scale(attention, weights, indices, mask):
    """[Q, K] per-edge scale: attention and/or quadrature weights (the mean
    divisor when neither), zeroed on masked edges."""
    if attention is not None:
        scale = attention
        if weights is not None:
            scale = scale * weights[indices]
    elif weights is not None:
        scale = weights[indices]
    else:
        counts = mask.sum(-1, keepdim=True).clamp(min=1)
        scale = 1.0 / counts.float()
    return torch.where(mask, scale, torch.zeros((), dtype=scale.dtype,
                                                device=scale.device))


class AGNO(nn.Module):
    def __init__(self, kernel_in: int, channel_mlp_features: Sequence[int],
                 transform_type: str = "linear", use_attn: bool = False,
                 attention_type: str = "cosine", coord_dim: Optional[int] = None,
                 attention_dim: int = 64, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        if transform_type not in _TRANSFORMS:
            raise ValueError(f"Invalid transform_type: {transform_type}")
        if use_attn:
            if coord_dim is None:
                raise ValueError("coord_dim must be specified when use_attn is True")
            if attention_type not in ("cosine", "dot_product"):
                raise ValueError(f"Invalid attention_type: {attention_type}")
        self.transform_type = transform_type
        self.use_attn = use_attn
        self.attention_type = attention_type
        self.coord_dim = coord_dim
        self.attention_dim = attention_dim
        self.channel_mlp = LinearChannelMLP(kernel_in, channel_mlp_features,
                                            dtype=dtype, device=device)
        if use_attn and attention_type == "dot_product":
            self.query_proj = Dense(coord_dim, attention_dim, compute_dtype=dtype,
                                    device=device)
            self.key_proj = Dense(coord_dim, attention_dim, compute_dtype=dtype,
                                  device=device)

    def _attention_weights(self, query_coords: torch.Tensor,
                           key_coords: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
        """α(x,y) over the K axis. query_coords [Q, 1, d]; key_coords [Q, K, d]."""
        if self.attention_type == "dot_product":
            q = self.query_proj(query_coords)
            k = self.key_proj(key_coords)
            scores = (q * k).sum(-1) / torch.tensor(
                math.sqrt(self.attention_dim), dtype=torch.float32).to(k.dtype)
        else:
            qn = query_coords / torch.linalg.vector_norm(
                query_coords, dim=-1, keepdim=True).clamp(min=1e-12)
            kn = key_coords / torch.linalg.vector_norm(
                key_coords, dim=-1, keepdim=True).clamp(min=1e-12)
            scores = (qn * kn).sum(-1)
        return masked_softmax(scores.float(), mask).to(key_coords.dtype)

    def forward(self, y: torch.Tensor, graph, x: Optional[torch.Tensor] = None,
                f_y: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None, tgraph=None,
                rep_coords: Optional[torch.Tensor] = None,
                encode: bool = False) -> torch.Tensor:
        """y [n, d1] sources; graph PaddedGraph [m, K] (or BucketedGraph);
        x [m, d2] queries (default y); f_y [B, n, c] or [n, c]; weights [n].
        Returns [B, m, c_out] (batched f_y) or [m, c_out]. A FlatGraph
        takes the vx route (:meth:`_call_vx`), which alone reads
        ``encode``."""
        if x is None:
            x = y
        if isinstance(graph, FlatGraph):
            return self._call_vx(y, graph, x, f_y, weights, encode)
        if isinstance(graph, BucketedGraph):
            return self._call_bucketed(y, graph, x, f_y, weights)
        if (tgraph is not None and f_y is not None and f_y.dim() == 2
                and self.transform_type == "linear"):
            raise ValueError("a vx batch takes the transpose-graph route as a "
                             "FlatGraph (data/graph_builder.py::vx_flat_graphs)")
        indices, mask = graph.indices, graph.mask
        if rep_coords is None:
            rep_coords = y[indices]                              # [Q, K, d1]
        self_coords = x[:, None, :]                              # [Q, 1, d2]
        batched = f_y is not None and f_y.dim() == 3
        nonlinear = self.transform_type in ("nonlinear", "nonlinear_kernelonly")
        multiply_f = (f_y is not None
                      and self.transform_type != "nonlinear_kernelonly")
        # A coordinate-only kernel shared by an fx batch folds into one
        # coefficient and runs the gather-multiply-reduce, its d_f over the
        # transpose graph where there is one and by a scatter where there is
        # none; a per-sample kernel does so only with a transpose graph.
        fold = multiply_f and (tgraph is not None or (batched and not nonlinear))
        # The per-edge features are gathered only where they are used (the
        # nonlinear kernel input or the plain reduce): on the folded route
        # the gather-multiply-reduce reads them itself.
        in_features = None
        if f_y is not None and (nonlinear or (multiply_f and not fold)):
            in_features = gather_rows(f_y, indices, 1 if batched else 0)

        attention = None
        if self.use_attn:
            attention = self._attention_weights(
                self_coords[..., :self.coord_dim],
                rep_coords[..., :self.coord_dim], mask)          # [Q, K]

        self_b = self_coords.expand(*rep_coords.shape[:-1], x.shape[-1])
        agg = torch.cat([rep_coords, self_b], dim=-1)            # [Q, K, d1+d2]
        if f_y is not None and nonlinear:
            if batched:
                agg = agg.unsqueeze(0).expand(f_y.shape[0], *agg.shape)
            agg = torch.cat([agg, in_features.to(agg.dtype)], dim=-1)
        kernel = self.channel_mlp(agg)
        if fold:
            scale = _edge_scale(attention, weights, indices, mask)[..., None]
            coef = kernel * (scale if kernel.dim() == scale.dim()
                             else scale[None]).to(kernel.dtype)
            # The shared coefficient runs the multiply-reduce kernels on the
            # card; a per-sample one (nonlinear transforms) runs plain.
            route = "cuda" if f_y.is_cuda and coef.dim() == 3 else "plain"
            record_route("agno", f"tgraph:{route}" if tgraph is not None
                         else f"dense:{route}:scatter-df")
            return apply_graph_transform(coef, f_y, graph, tgraph)

        out = kernel
        if multiply_f:
            out = out * in_features if out.dim() == in_features.dim() \
                else out[None] * in_features
        if attention is not None:
            att = attention[..., None].to(out.dtype)
            out = out * att if out.dim() == 3 else out * att[None]
        if weights is not None:
            nbr_w = weights[indices][..., None].to(out.dtype)
            out = out * (nbr_w if out.dim() == 3 else nbr_w[None])
            reduction = "sum"
        else:
            reduction = "sum" if self.use_attn else "mean"
        m = mask if out.dim() == 3 else mask[None]
        m = m[..., None].expand(out.shape)
        return masked_sum(out, m) if reduction == "sum" else masked_mean(out, m)

    def _folded_coef(self, y: torch.Tensor, graph, x: torch.Tensor,
                     weights: Optional[torch.Tensor],
                     rep_coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-edge coefficient of one degree bucket: kernel-MLP output with
        attention / quadrature / mean weights and the padding mask folded in
        as one scale cast to the kernel dtype. x: [Qb, d] bucket queries;
        rep_coords: y[indices] where the caller has read them."""
        indices, mask = graph.indices, graph.mask
        if rep_coords is None:
            rep_coords = y[indices]
        self_coords = x[:, None, :]
        attention = None
        if self.use_attn:
            attention = self._attention_weights(
                self_coords[..., :self.coord_dim],
                rep_coords[..., :self.coord_dim], mask)
        self_b = self_coords.expand(*rep_coords.shape[:-1], x.shape[-1])
        coef = self.channel_mlp(torch.cat([rep_coords, self_b], dim=-1))
        scale = _edge_scale(attention, weights, indices, mask)
        return coef * scale[..., None].to(coef.dtype)

    def _call_bucketed(self, y, bg: BucketedGraph, x, f_y, weights):
        """Transform over a degree-bucketed graph. x holds the
        bucket-concatenated query coords; the result stays in that row
        order (the caller unpermutes)."""
        multiply_f = (f_y is not None
                      and self.transform_type != "nonlinear_kernelonly")
        nonlinear = self.transform_type in ("nonlinear", "nonlinear_kernelonly")
        # Without a transpose graph the JAX package runs the plain
        # per-bucket body here; the combined route computes the same, its
        # d_f by a scatter (ops/gather_apply.py::_scatter_df).
        combined = multiply_f and not nonlinear and f_y.dim() in (2, 3)
        if combined and f_y.dim() == 2:
            raise ValueError("a vx batch takes the bucketed route as a FlatGraph "
                             "(data/graph_builder.py::vx_flat_graphs)")
        if combined:
            route = "bucketed:" + ("cuda" if f_y.is_cuda else "plain")
            record_route("agno", route if bg.tgraph is not None
                         else route + ":scatter-df")
        else:
            record_route("agno", "bucketed-plain")
        parts, offset = [], 0
        for graph in bg.buckets:
            nb = graph.indices.shape[-2]
            xs = x[offset:offset + nb]
            offset += nb
            if combined:
                parts.append(self._folded_coef(y, graph, xs, weights))
            else:
                parts.append(self.forward(y, graph, x=xs, f_y=f_y,
                                          weights=weights))
        if combined:
            return apply_bucketed_graph_transform(parts, f_y, bg)
        return torch.cat(parts, dim=-2)

    def _call_vx(self, y, vg: FlatGraph, x_cat, f_y, weights, encode=False):
        """A transform over a flattened vx batch. y [B·n, d] and x_cat
        [B·R, d] (the rows' query coordinates) are raw coordinates; per
        degree bucket the neighbours' rows are read once, and the
        geometric embedding reuses them. ``encode`` (magno.node_embedding)
        feeds the kernel the Fourier encodings of those rows and queries,
        taken after the read: the encoding is per row, so this is the JAX
        package's encode-then-gather, and the rows read stay the raw ones.

        - linear and linear_kernelonly (after the JAX package's
          ``_call_flat_km`` and ``_call_bucketed_aug``): the per-edge
          coefficient per bucket, then one reduce per bucket over every
          sample (:func:`flat_gather_multiply_reduce`; its d_f by a scatter
          where the graph has no transpose graph);
        - nonlinear and nonlinear_kernelonly: the per-edge body of
          :meth:`forward` per bucket, the kernel MLP on [y ‖ x ‖ f] and a
          masked sum or mean, as the JAX package runs them (its trainers
          keep these graphs dense and the models drop their transpose
          graphs, so autograd gives d_f).

        Returns (out [B·R, c_out] sample-major, per-bucket coordinate rows
        [B·R_j, K_j, d1], per-bucket queries [B·R_j, d2])."""
        if f_y is None or f_y.dim() != 2:
            raise ValueError("a vx batch's features are flat rows [B·n, c]")
        b = vg.num_samples
        x3 = x_cat.view(b, vg.rows, x_cat.shape[-1])
        nonlinear = self.transform_type in ("nonlinear", "nonlinear_kernelonly")
        parts, reps, queries, base = [], [], [], 0
        for g in vg.buckets:
            rj = g.indices.shape[0] // b
            xs = x3[:, base:base + rj].reshape(b * rj, -1)
            rep = y[g.indices]                                   # [B·R_j, K_j, d1]
            rep_k, xs_k = rep, xs
            if encode:
                rep_k = node_pos_encode(rep.reshape(-1, rep.shape[-1])).view(
                    *rep.shape[:-1], -1)
                xs_k = node_pos_encode(xs)
            if nonlinear:
                parts.append(self.forward(y, g, x=xs_k, f_y=f_y, weights=weights,
                                          rep_coords=rep_k).view(b, rj, -1))
            else:
                parts.append(self._folded_coef(y, g, xs_k, weights, rep_k))
            reps.append(rep)
            queries.append(xs)
            base += rj
        if nonlinear:
            record_route("agno", "vx-plain")
            out = (parts[0] if len(parts) == 1 else torch.cat(parts, 1)).reshape(
                b * vg.rows, -1)
            return out, tuple(reps), tuple(queries)
        route = "vx:" + ("cuda" if f_y.is_cuda else "plain")
        record_route("agno", route if vg.tgraph is not None else route + ":scatter-df")
        return flat_gather_multiply_reduce(parts, f_y, vg), tuple(reps), tuple(queries)
