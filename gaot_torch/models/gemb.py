"""Geometric embedding and node positional encoding.

Counterpart of ``gaot_tpu/models/gemb.py``, both methods:

- statistical: per-query neighbor count, mean/variance of distances,
  centroid offset and covariance eigenvalues (closed-form symmetric 2x2/3x3
  solvers), standardized over the queries and passed through a two-layer
  MLP. On a vx batch the standardization runs per sample, over its valid
  rows across the degree buckets (:func:`_standardize_valid_grouped`);
  under spatial parallelism, fx or vx, over the rows of every rank
  (:func:`_standardize_spread`);
- pointnet: a shared MLP on the query-centred neighbour coordinates, ReLU,
  masked max / mean / sum pooling over K, then ``fc`` and ReLU; a query
  without a valid edge gets zeros. Per row, so a bucketed or vx graph needs
  no standardization.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.gather_apply import FlatGraph
from ..ops.padding import BucketedGraph
from ..ops.segment_ops import masked_max, masked_mean, masked_sum
from ..parallel import comm
from .mlp import Dense


def node_pos_encode(x: torch.Tensor, freq: int = 4) -> torch.Tensor:
    """Fourier node positional encoding: x [n, d] in [-1, 1] → [n, d·2·freq]."""
    freqs = torch.arange(1, freq + 1, dtype=x.dtype, device=x.device)
    phi = math.pi * (x + 1.0)
    angles = freqs[None, :, None] * phi[:, None, :]              # [n, freq, d]
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=2)
    return enc.reshape(x.shape[0], -1)


def eigvalsh_2x2(cov: torch.Tensor) -> torch.Tensor:
    """Descending eigenvalues of symmetric 2x2 matrices. cov: [..., 2, 2]."""
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    mean = 0.5 * (a + c)
    disc = torch.sqrt((0.25 * (a - c) ** 2 + b * b).clamp(min=0.0))
    return torch.stack([mean + disc, mean - disc], dim=-1)


def eigvalsh_3x3(cov: torch.Tensor) -> torch.Tensor:
    """Descending eigenvalues of symmetric 3x3 matrices (trigonometric
    method); degenerate (≈scalar) matrices give the diagonal mean."""
    a11, a22, a33 = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    a12, a13, a23 = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    q = (a11 + a22 + a33) / 3.0
    p1 = a12 ** 2 + a13 ** 2 + a23 ** 2
    p2 = (a11 - q) ** 2 + (a22 - q) ** 2 + (a33 - q) ** 2 + 2.0 * p1
    p = torch.sqrt((p2 / 6.0).clamp(min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    b11, b22, b33 = (a11 - q) / safe_p, (a22 - q) / safe_p, (a33 - q) / safe_p
    b12, b13, b23 = a12 / safe_p, a13 / safe_p, a23 / safe_p
    det_b = (b11 * (b22 * b33 - b23 * b23)
             - b12 * (b12 * b33 - b23 * b13)
             + b13 * (b12 * b23 - b22 * b13))
    r = (det_b / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    degenerate = p2 <= 0
    e1 = torch.where(degenerate, q, e1)
    e2 = torch.where(degenerate, q, e2)
    e3 = torch.where(degenerate, q, e3)
    return torch.stack([e1, e2, e3], dim=-1)


def raw_statistical_features(input_geom: torch.Tensor,
                             latent_queries: torch.Tensor, graph,
                             nbr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unnormalized per-query geometric statistics: input_geom [N, d],
    latent_queries [Q, d], graph [Q, K] → [Q, 3 + 2d]. ``nbr`` optionally
    supplies the pre-gathered input_geom[indices]."""
    indices, mask = graph.indices, graph.mask
    d = latent_queries.shape[-1]
    if nbr is None:
        nbr = input_geom[indices]                                # [Q, K, d]
    diff = (nbr - latent_queries[:, None, :]).float()
    dist2 = (diff * diff).sum(-1)
    dist = torch.sqrt(dist2.clamp(min=0.0))
    iu, ju = np.triu_indices(d)
    pairs = torch.stack([diff[..., int(i)] * diff[..., int(j)]
                         for i, j in zip(iu, ju)], dim=-1)
    feat = torch.cat([torch.ones_like(dist)[..., None], dist[..., None],
                      dist2[..., None], diff, pairs], dim=-1)    # [Q, K, F]
    feat = torch.where(mask[..., None], feat, torch.zeros((), device=feat.device))
    sums = feat.sum(1)                                           # [Q, F]

    counts = sums[:, 0]
    has_nbrs = counts > 0
    inv_n = 1.0 / counts.clamp(min=1.0)
    d_avg = sums[:, 1] * inv_n
    d_var = (sums[:, 2] * inv_n - d_avg * d_avg).clamp(min=0.0)
    delta = sums[:, 3:3 + d] * inv_n[:, None]                    # centroid - x
    raw2 = sums[:, 3 + d:] * inv_n[:, None]                      # [Q, P]
    pair_pos = {(int(i), int(j)): col for col, (i, j) in enumerate(zip(iu, ju))}
    cvals = [raw2[:, col] - delta[:, int(i)] * delta[:, int(j)]
             for col, (i, j) in enumerate(zip(iu, ju))]
    cov = torch.stack(
        [torch.stack([cvals[pair_pos[(min(r, s), max(r, s))]]
                      for s in range(d)], dim=-1)
         for r in range(d)], dim=-2)                             # [Q, d, d]
    eig = eigvalsh_2x2(cov) if d == 2 else eigvalsh_3x3(cov)
    eig = torch.where(has_nbrs[:, None], eig, torch.zeros_like(eig))
    feats = torch.cat([counts[:, None], d_avg[:, None], d_var[:, None], delta,
                       eig], dim=-1).to(input_geom.dtype)
    return torch.where(has_nbrs[:, None], feats, torch.zeros_like(feats))


def _standardize_spread(feats: torch.Tensor, valid: Optional[torch.Tensor],
                        group) -> torch.Tensor:
    """Standardization of each sample's (valid) rows over the ranks of
    ``group``, which each hold a range of them (spatial parallelism): the
    sums and counts summed over the ranks (an all-reduce forward and
    backward), the unbiased std of one process. feats [S, R, F], valid
    [S, R] or None (every row counts)."""
    v = (torch.ones_like(feats[..., :1]) if valid is None
         else valid.to(feats.dtype)[..., None])
    n = comm.sum_over(v.sum(1, keepdim=True), group)
    mean = comm.sum_over((feats * v).sum(1, keepdim=True), group) / n.clamp(min=1.0)
    var = comm.sum_over((((feats - mean) ** 2) * v).sum(1, keepdim=True),
                        group) / (n - 1.0).clamp(min=1.0)
    std = torch.sqrt(var)
    std = torch.where(std < 1e-6, torch.ones_like(std), std)
    return (feats - mean) / std


def _standardize_grouped(feats: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Standardize over queries per sample (unbiased std, as torch .std)."""
    flat_q = feats.shape[0]
    per = flat_q // num_samples
    grouped = feats.reshape(num_samples, per, -1)
    mean = grouped.mean(1, keepdim=True)
    var = grouped.var(1, keepdim=True, unbiased=False) * (per / max(per - 1, 1))
    std = torch.sqrt(var)
    std = torch.where(std < 1e-6, torch.ones_like(std), std)
    return ((grouped - mean) / std).reshape(flat_q, -1)


def _standardize_valid(feats: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Standardize over the valid rows only (bucketed layouts carry
    tile-padding rows that must not shift the statistics)."""
    v = row_valid.to(feats.dtype)[:, None]
    n = v.sum()
    mean = (feats * v).sum(0, keepdim=True) / n.clamp(min=1.0)
    var = (((feats - mean) ** 2) * v).sum(0, keepdim=True) / (n - 1.0).clamp(min=1.0)
    std = torch.sqrt(var)
    std = torch.where(std < 1e-6, torch.ones_like(std), std)
    return (feats - mean) / std


def _standardize_valid_grouped(feats: torch.Tensor,
                               row_valid: torch.Tensor) -> torch.Tensor:
    """Per-sample standardization over the valid rows of a vx batch's
    bucket-concatenated rows: feats [B, R, F], row_valid [B, R] (after the
    JAX package's function of this name, on its bucket-major layout);
    unbiased std as torch's, in fp32."""
    f32 = feats.float()
    v = row_valid.float()[..., None]
    cnt = v.sum(1, keepdim=True)
    mean = (f32 * v).sum(1, keepdim=True) / cnt.clamp(min=1.0)
    var = (((f32 - mean) ** 2) * v).sum(1, keepdim=True) / (cnt - 1.0).clamp(min=1.0)
    std = torch.sqrt(var)
    std = torch.where(std < 1e-6, torch.ones_like(std), std)
    return ((f32 - mean) / std).to(feats.dtype)


class GeometricEmbedding(nn.Module):
    """Per-query geometric embedding: statistical (``mlp.0``, ``mlp.2``) or
    pointnet (``pointnet_mlp.0``, ``pointnet_mlp.2``, ``fc.0``)."""

    def __init__(self, coord_dim: int, output_dim: int,
                 method: str = "statistical", pooling: str = "max",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.method = method
        dense = lambda i, o: Dense(i, o, compute_dtype=dtype, device=device)
        if method == "statistical":
            self.mlp = nn.Sequential(dense(3 + 2 * coord_dim, 64), nn.ReLU(),
                                     dense(64, output_dim), nn.ReLU())
        elif method == "pointnet":
            if pooling not in ("max", "mean", "sum"):
                raise ValueError(f"Unsupported pooling method: {pooling}")
            self.pooling = pooling
            self.pointnet_mlp = nn.Sequential(dense(coord_dim, 64), nn.ReLU(),
                                              dense(64, 64))
            self.fc = nn.Sequential(dense(64, output_dim), nn.ReLU())
        else:
            raise ValueError(f"Unknown geometric embedding method: {method}")
        # Spatial parallelism: the ranks whose queries the statistical
        # features are standardized over (GAOT.shard_queries sets it).
        self.group = None

    def _pointnet(self, input_geom: torch.Tensor, latent_queries: torch.Tensor,
                  graph, nbr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pointnet embedding of one graph [Q, K]: [Q, output_dim]."""
        mask = graph.mask
        if nbr is None:
            nbr = input_geom[graph.indices]                      # [Q, K, d]
        h = torch.relu(self.pointnet_mlp(nbr - latent_queries[:, None, :]))
        pool = {"max": masked_max, "mean": masked_mean, "sum": masked_sum}[self.pooling]
        out = self.fc(pool(h, mask))
        return torch.where(mask.any(-1)[:, None], out, torch.zeros((), dtype=out.dtype,
                                                                   device=out.device))

    def forward(self, input_geom: torch.Tensor, latent_queries: torch.Tensor,
                graph, num_samples: int = 1,
                nbr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """graph: PaddedGraph [Q, K], or BucketedGraph with latent_queries
        in bucket-concatenated order (the result is in that order too), or
        a FlatGraph with latent_queries and nbr its per-bucket queries and
        coordinate rows (the result [B·R, C] in its row order)."""
        pointnet = self.method == "pointnet"
        features = self._pointnet if pointnet else raw_statistical_features
        if isinstance(graph, FlatGraph):
            b = graph.num_samples
            parts = [features(input_geom, q, g, rep).view(b, q.shape[0] // b, -1)
                     for q, g, rep in zip(latent_queries, graph.buckets, nbr)]
            feats = (parts[0] if len(parts) == 1 else torch.cat(parts, 1)).reshape(
                b * graph.rows, -1)
            if pointnet:
                return feats
            if self.group is not None:
                # Spatial parallelism: each sample's rows lie on every rank.
                valid = (None if graph.row_valid is None
                         else graph.row_valid.view(b, graph.rows))
                f = feats.view(b, graph.rows, -1)
                f = f if valid is None else f.float()
                return self.mlp(_standardize_spread(f, valid, self.group).to(
                    feats.dtype).reshape(b * graph.rows, -1))
            if graph.row_valid is None:
                return self.mlp(_standardize_grouped(feats, b))
            return self.mlp(_standardize_valid_grouped(
                feats.view(b, graph.rows, -1), graph.row_valid.view(b, graph.rows)
            ).reshape(b * graph.rows, -1))
        if isinstance(graph, BucketedGraph):
            parts, offset = [], 0
            for g in graph.buckets:
                nb = g.indices.shape[-2]
                parts.append(features(input_geom, latent_queries[offset:offset + nb], g))
                offset += nb
            feats = torch.cat(parts, dim=0)
            if pointnet:
                return feats
            if num_samples > 1:
                # The JAX package's vx bucketed standardization is the
                # FlatGraph branch above: vx batches reach the embedding as
                # FlatGraphs (data/graph_builder.py::vx_flat_graphs).
                raise ValueError("a BucketedGraph is an fx graph (one sample); a vx "
                                 "batch's graph is a FlatGraph")
            if self.group is not None:
                return self.mlp(_standardize_spread(feats[None], graph.row_valid[None],
                                                    self.group)[0])
            return self.mlp(_standardize_valid(feats, graph.row_valid))
        feats = features(input_geom, latent_queries, graph, nbr)
        if pointnet:
            return feats
        if self.group is not None:
            return self.mlp(_standardize_spread(feats[None], None, self.group)[0])
        return self.mlp(_standardize_grouped(feats, num_samples))
