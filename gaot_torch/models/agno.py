"""Attentional Graph Neural Operator (AGNO) on padded neighborhoods.

Counterpart of ``gaot_tpu/models/agno.py`` for fx graphs:

    out(x) = reduce_{y in A(x)} α(x,y) · k(x, y[, f(y)]) [· f(y)]

over a padded K-neighborhood A(x). In 'linear' modes the kernel depends only
on coordinates, so kernel values are computed once per graph and shared by
the whole batch; attention, quadrature/mean weights and the padding mask fold
into one per-edge scale cast to the kernel dtype, and one
gather-multiply-reduce applies the coefficient to the features.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.gather_apply import apply_bucketed_graph_transform, apply_graph_transform
from ..ops.padding import BucketedGraph
from ..ops.segment_ops import masked_mean, masked_softmax, masked_sum
from ..utils.routing import record_route
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
                rep_coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y [n, d1] sources; graph PaddedGraph [m, K] (or BucketedGraph);
        x [m, d2] queries (default y); f_y [B, n, c] or [n, c]; weights [n].
        Returns [B, m, c_out] (batched f_y) or [m, c_out]."""
        if x is None:
            x = y
        if isinstance(graph, BucketedGraph):
            return self._call_bucketed(y, graph, x, f_y, weights)
        if (tgraph is not None and f_y is not None and f_y.dim() == 2
                and self.transform_type == "linear"):
            raise NotImplementedError("the vx-flattened K-major route is not ported")
        indices, mask = graph.indices, graph.mask
        if rep_coords is None:
            rep_coords = y[indices]                              # [Q, K, d1]
        self_coords = x[:, None, :]                              # [Q, 1, d2]
        batched = f_y is not None and f_y.dim() == 3
        nonlinear = self.transform_type in ("nonlinear", "nonlinear_kernelonly")
        multiply_f = (f_y is not None
                      and self.transform_type != "nonlinear_kernelonly")
        # The per-edge features are gathered only where they are used (the
        # nonlinear kernel input or the plain reduce): on the transpose-graph
        # route the gather-multiply-reduce gathers them itself.
        in_features = None
        if f_y is not None and (nonlinear or (multiply_f and tgraph is None)):
            in_features = f_y[:, indices, :] if batched else f_y[indices]

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
        if multiply_f and tgraph is not None:
            scale = _edge_scale(attention, weights, indices, mask)[..., None]
            coef = kernel * (scale if kernel.dim() == scale.dim()
                             else scale[None]).to(kernel.dtype)
            # The shared coefficient runs the multiply-reduce kernels on the
            # card; a per-sample one (nonlinear transforms) runs plain.
            record_route("agno", "tgraph:" + ("cuda" if f_y.is_cuda and coef.dim() == 3
                                              else "plain"))
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
                     weights: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-edge coefficient of one degree bucket: kernel-MLP output with
        attention / quadrature / mean weights and the padding mask folded in
        as one scale cast to the kernel dtype. x: [Qb, d] bucket queries."""
        indices, mask = graph.indices, graph.mask
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
        combined = (multiply_f and not nonlinear and bg.tgraph is not None
                    and f_y.dim() in (2, 3))
        if combined and f_y.dim() == 2:
            raise NotImplementedError("the vx-flattened bucketed route is not ported")
        record_route("agno", ("bucketed:cuda" if f_y.is_cuda else "bucketed:plain")
                     if combined else "bucketed-plain")
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
