"""MAGNO — Multiscale Attentional Graph Neural Operator encoder/decoder.

Counterpart of ``gaot_tpu/models/magno.py``. Graphs are precomputed on the
host (data/graph_builder.py). fx batches share one graph, so kernel values
are computed once per graph and broadcast over the batch. vx batches (a
mesh per sample) are folded into the query axis: each sample's nodes join
one flat point set, and the data pipeline hands each scale's graph over
as one FlatGraph with per-sample offset indices
(``data/graph_builder.py::vx_flat_graphs``), so one AGNO call covers the
whole batch.

Edge drop (``magno.sampling_strategy``) thins the graphs' masks in
training only, when the forward is given a ``torch.Generator``: the dense
graph, or each degree bucket before both the AGNO transform and the
geometric embedding read it, so both see the same neighbourhoods; the
uniforms are drawn in query order over the uncut graph, which a rank of
spatial parallelism draws whole (``ops/edge_drop.py::bucket_uniforms``). The
transpose graphs stay as built: a dropped edge's coefficient is zero, so
the gradient through them stays exact.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core.config import MAGNOConfig
from ..ops.edge_drop import apply_edge_drop_mask, bucket_uniforms
from ..ops.gather_apply import FlatGraph, permute_rows, unpermute_rows
from ..ops.padding import BucketedGraph
from .agno import AGNO
from .gemb import GeometricEmbedding, node_pos_encode
from .mlp import ChannelMLP, ScaleWeightMLP


def _kernel_coord_dim(config: MAGNOConfig) -> int:
    return config.coord_dim * 4 * 2 if config.node_embedding else config.coord_dim


class _MAGNOBase(nn.Module):
    """Shared multiscale AGNO + geometric-embedding machinery. f_channels is
    the width of the features the AGNO is fed (the encoder's lifted width),
    which the nonlinear kernel MLP takes beside the coordinates, as the
    Flax Dense infers it from its input."""

    def __init__(self, f_channels: int, config: MAGNOConfig,
                 agno_out_channels: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        cfg = self.config = config
        kdim = _kernel_coord_dim(cfg)
        kernel_in = kdim * 2
        if cfg.transform_type in ("nonlinear", "nonlinear_kernelonly"):
            kernel_in += f_channels
        mlp_sizes = [cfg.hidden_size] * cfg.mlp_layers + [agno_out_channels]
        self.agno = AGNO(kernel_in, mlp_sizes, transform_type=cfg.transform_type,
                         use_attn=cfg.use_attention,
                         attention_type=cfg.attention_type, coord_dim=kdim,
                         dtype=dtype, device=device)
        if cfg.use_geoembed:
            self.geoembed = GeometricEmbedding(cfg.coord_dim, agno_out_channels,
                                               method=cfg.embedding_method,
                                               pooling=cfg.pooling, dtype=dtype,
                                               device=device)
            self.recovery = ChannelMLP(2 * agno_out_channels, agno_out_channels,
                                       n_layers=1, dtype=dtype, device=device)
        if cfg.use_scale_weights:
            self.scale_weighting = ScaleWeightMLP(
                cfg.coord_dim, len(cfg.scales), cfg.hidden_size // 4,
                dtype=dtype, device=device)
        # Spatial parallelism (GAOT.shard_queries): (each sample's query rows
        # in the uncut graphs, this rank's first, the draw width per scale).
        self.draw = None

    def _drop_edges(self, graph, generator: Optional[torch.Generator], scale: int = 0):
        """The graph of scale ``scale`` with its masks thinned by edge drop (a
        new graph; the one given is not written): a PaddedGraph, or each
        bucket of a BucketedGraph or FlatGraph, from the uniforms of
        ``ops/edge_drop.py::bucket_uniforms`` (a vx graph's rows are its
        samples', and a data-parallel step draws the global batch's numbers
        for them; under spatial parallelism the draw is the uncut graph's,
        :attr:`draw`). Without a generator (evaluation) or a sampling
        strategy the graph itself."""
        cfg = self.config
        layout = None
        if self.draw is not None and generator is not None \
                and cfg.sampling_strategy is not None:
            rows, offset, widths = self.draw
            if widths is None:
                raise ValueError("edge drop under spatial parallelism draws over the "
                                 "uncut graphs: the shard needs their draw widths "
                                 "(SpatialShard.widths)")
            layout = (rows, offset, widths[scale])
        draws = bucket_uniforms(graph, generator, cfg.sampling_strategy,
                                cfg.max_neighbors, cfg.sample_ratio, layout)
        if draws is None:
            return graph

        def drop(g, u):
            return g._replace(mask=apply_edge_drop_mask(
                g.mask, u, cfg.sampling_strategy, cfg.max_neighbors, cfg.sample_ratio))
        if isinstance(graph, (BucketedGraph, FlatGraph)):
            return graph._replace(buckets=tuple(
                drop(g, u) for g, u in zip(graph.buckets, draws)))
        return drop(graph, draws[0])

    def _agno_scale_vx(self, src_coords, dst_coords, f_src, vg: FlatGraph,
                       generator=None, scale: int = 0):
        """One scale of a vx batch: the AGNO transform over the flattened
        graph, the geometric embedding from the same raw coordinate rows
        (standardized per sample), recovery, then the rows back to query
        order. Under ``node_embedding`` the AGNO's kernel takes the rows'
        Fourier encodings and the embedding the raw rows, as in the JAX
        package. src [B·n, d], dst [B·m, d], f_src [B·n, c]. Returns
        [B·m, c]."""
        cfg = self.config
        vg = self._drop_edges(vg, generator, scale)
        x_cat = dst_coords if vg.perm is None else dst_coords.index_select(0, vg.perm)
        out, reps, queries = self.agno(src_coords, vg, x=x_cat, f_y=f_src,
                                       encode=cfg.node_embedding)
        if cfg.use_geoembed:
            gemb = self.geoembed(src_coords, queries, vg, nbr=reps)
            out = self.recovery(torch.cat([out, gemb], dim=-1))
        return out if vg.perm is None else permute_rows(out, vg.inv_perm, vg.perm,
                                                        vg.row_valid)

    def _agno_scale(self, src_coords, dst_coords, f_src, graph, tgraph=None,
                    generator=None, scale: int = 0):
        """One scale: AGNO transform + optional geometric embedding +
        recovery. src [n, d], dst [m, d], f_src [B, n, c], graph [m, K]."""
        cfg = self.config
        if isinstance(graph, BucketedGraph):
            return self._agno_scale_bucketed(src_coords, dst_coords, f_src, graph,
                                             generator, scale)
        if f_src.dim() != 3:
            raise ValueError("fx features are [B, n, c]; a vx batch takes "
                             "_agno_scale_vx")
        graph = self._drop_edges(graph, generator, scale)
        if cfg.node_embedding:
            src_proc, dst_proc = node_pos_encode(src_coords), node_pos_encode(dst_coords)
        else:
            src_proc, dst_proc = src_coords, dst_coords
        rep = None
        if cfg.use_geoembed and not cfg.node_embedding:
            rep = src_coords[graph.indices]
        out = self.agno(src_proc, graph, x=dst_proc, f_y=f_src, tgraph=tgraph,
                        rep_coords=rep)
        if cfg.use_geoembed:
            gemb = self.geoembed(src_coords, dst_coords, graph, nbr=rep)
            gemb = gemb.unsqueeze(0).expand(out.shape[0], *gemb.shape)
            out = self.recovery(torch.cat([out, gemb], dim=-1))
        return out

    def _agno_scale_bucketed(self, src_coords, dst_coords, f_src,
                             bg: BucketedGraph, generator=None, scale: int = 0):
        """One scale over a degree-bucketed graph: per-bucket transforms in
        degree-sorted order, then back to original query order."""
        cfg = self.config
        bg = self._drop_edges(bg, generator, scale)
        dst_cat = dst_coords.index_select(0, bg.perm)
        src_proc = node_pos_encode(src_coords) if cfg.node_embedding else src_coords
        dst_proc = node_pos_encode(dst_cat) if cfg.node_embedding else dst_cat
        cat = self.agno(src_proc, bg, x=dst_proc, f_y=f_src)
        if cfg.use_geoembed:
            gemb = self.geoembed(src_coords, dst_cat, bg)
            if cat.dim() == 3:
                gemb = gemb.unsqueeze(0).expand(cat.shape[0], *gemb.shape)
            cat = self.recovery(torch.cat([cat, gemb], dim=-1))
        return unpermute_rows(cat, bg.inv_perm, bg.perm, bg.row_valid)

    def _combine_scales(self, per_scale: Sequence[torch.Tensor],
                        weight_coords: torch.Tensor) -> torch.Tensor:
        """Mean or learned softmax-weighted combination over scales."""
        if len(per_scale) == 1:
            return per_scale[0]
        stacked = torch.stack(list(per_scale), dim=0)          # [S, B, m, c]
        if self.config.use_scale_weights:
            w = torch.softmax(self.scale_weighting(weight_coords), dim=-1)
            w = w.movedim(-1, 0)[..., None]                    # [S, m, 1]
            while w.dim() < stacked.dim():
                w = w.unsqueeze(1)
            return (stacked * w).sum(0)
        return stacked.mean(0)


class MAGNOEncoder(_MAGNOBase):
    """Physical nodes → latent grid."""

    def __init__(self, in_channels: int, out_channels: int, config: MAGNOConfig,
                 agno_out_channels: int, lifting_layers: int = 1,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(out_channels, config, agno_out_channels, dtype=dtype,
                         device=device)
        self.lifting = ChannelMLP(in_channels, out_channels,
                                  hidden_channels=config.hidden_size,
                                  n_layers=lifting_layers, dtype=dtype,
                                  device=device)

    def forward(self, x_coord, pndata, latent_tokens_coord, graphs, tgraphs=None,
                generator=None):
        """x_coord [N, d] (fx) or [B, N, d] (vx); pndata [B, N, Cin];
        latent_tokens_coord [Q, d]; graphs: per-scale graphs, [Q, K] (fx)
        or FlatGraphs over the batch (vx); ``generator`` draws the edge drop
        (training; None: nothing dropped). Returns [B, Q, Cout]."""
        tgraphs = tgraphs or [None] * len(graphs)
        lifted = self.lifting(pndata)
        if x_coord.dim() == 3:
            b, n, _ = x_coord.shape
            q = latent_tokens_coord.shape[0]
            src = x_coord.reshape(b * n, -1)
            dst = latent_tokens_coord.repeat(b, 1)
            f = lifted.reshape(b * n, -1)
            per_scale = [self._agno_scale_vx(src, dst, f, vg, generator, si).view(b, q, -1)
                         for si, vg in enumerate(graphs)]
            return self._combine_scales(per_scale, latent_tokens_coord)
        per_scale = [self._agno_scale(x_coord, latent_tokens_coord, lifted, g, t,
                                      generator, si)
                     for si, (g, t) in enumerate(zip(graphs, tgraphs))]
        return self._combine_scales(per_scale, latent_tokens_coord)


class MAGNODecoder(_MAGNOBase):
    """Latent grid → query nodes."""

    def __init__(self, in_channels: int, out_channels: int, config: MAGNOConfig,
                 agno_out_channels: int, projection_layers: int = 1,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(in_channels, config, agno_out_channels, dtype=dtype,
                         device=device)
        self.projection = ChannelMLP(agno_out_channels, out_channels,
                                     hidden_channels=config.hidden_size,
                                     n_layers=projection_layers, dtype=dtype,
                                     device=device)

    def forward(self, latent_tokens_coord, rndata, query_coord, graphs,
                tgraphs=None, generator=None):
        """latent_tokens_coord [Q, d]; rndata [B, Q, C]; query_coord [M, d]
        (fx) or [B, M, d] (vx); graphs: per-scale graphs, [M, K] (fx) or
        FlatGraphs over the batch (vx); ``generator`` as the encoder's.
        Returns [B, M, Cout]."""
        tgraphs = tgraphs or [None] * len(graphs)
        if query_coord.dim() == 3:
            b, m, _ = query_coord.shape
            q = latent_tokens_coord.shape[0]
            src = latent_tokens_coord.repeat(b, 1)
            dst = query_coord.reshape(b * m, -1)
            f = rndata.reshape(b * q, -1)
            per_scale = [self._agno_scale_vx(src, dst, f, vg, generator, si).view(b, m, -1)
                         for si, vg in enumerate(graphs)]
            return self.projection(self._combine_scales_vx(per_scale, query_coord))
        per_scale = [self._agno_scale(latent_tokens_coord, query_coord, rndata, g, t,
                                      generator, si)
                     for si, (g, t) in enumerate(zip(graphs, tgraphs))]
        return self.projection(self._combine_scales(per_scale, query_coord))

    def _combine_scales_vx(self, per_scale, query_coord):
        """Scale weights from each sample's own query coordinates
        [B, M, d] (the original code reuses the first sample's)."""
        if len(per_scale) == 1:
            return per_scale[0]
        stacked = torch.stack(list(per_scale), dim=0)          # [S, B, M, c]
        if self.config.use_scale_weights:
            w = torch.softmax(self.scale_weighting(query_coord), dim=-1)
            return (stacked * w.movedim(-1, 0)[..., None]).sum(0)
        return stacked.mean(0)
