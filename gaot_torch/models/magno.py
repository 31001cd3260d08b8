"""MAGNO — Multiscale Attentional Graph Neural Operator encoder/decoder.

Counterpart of the fx branches of ``gaot_tpu/models/magno.py``. Graphs are
precomputed on the host (data/graph_builder.py); fx batches share one graph,
so kernel values are computed once per graph and broadcast over the batch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core.config import MAGNOConfig
from ..ops.gather_apply import unpermute_rows
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
        if cfg.sampling_strategy is not None:
            raise NotImplementedError("edge drop (sampling_strategy) is not ported")
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
                                               dtype=dtype, device=device)
            self.recovery = ChannelMLP(2 * agno_out_channels, agno_out_channels,
                                       n_layers=1, dtype=dtype, device=device)
        if cfg.use_scale_weights:
            self.scale_weighting = ScaleWeightMLP(
                cfg.coord_dim, len(cfg.scales), cfg.hidden_size // 4,
                dtype=dtype, device=device)

    def _agno_scale(self, src_coords, dst_coords, f_src, graph, tgraph=None):
        """One scale: AGNO transform + optional geometric embedding +
        recovery. src [n, d], dst [m, d], f_src [B, n, c], graph [m, K]."""
        cfg = self.config
        if isinstance(graph, BucketedGraph):
            return self._agno_scale_bucketed(src_coords, dst_coords, f_src, graph)
        if f_src.dim() != 3:
            raise NotImplementedError("vx-flattened MAGNO is not ported")
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
                             bg: BucketedGraph):
        """One scale over a degree-bucketed graph: per-bucket transforms in
        degree-sorted order, then back to original query order."""
        cfg = self.config
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

    def forward(self, x_coord, pndata, latent_tokens_coord, graphs, tgraphs=None):
        """x_coord [N, d]; pndata [B, N, Cin]; latent_tokens_coord [Q, d];
        graphs: per-scale graphs. Returns [B, Q, Cout]."""
        if x_coord.dim() != 2:
            raise NotImplementedError("vx coordinates are not ported")
        tgraphs = tgraphs or [None] * len(graphs)
        lifted = self.lifting(pndata)
        per_scale = [self._agno_scale(x_coord, latent_tokens_coord, lifted, g, t)
                     for g, t in zip(graphs, tgraphs)]
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
                tgraphs=None):
        """latent_tokens_coord [Q, d]; rndata [B, Q, C]; query_coord [M, d];
        graphs: per-scale graphs [M, K]. Returns [B, M, Cout]."""
        if query_coord.dim() != 2:
            raise NotImplementedError("vx coordinates are not ported")
        tgraphs = tgraphs or [None] * len(graphs)
        per_scale = [self._agno_scale(latent_tokens_coord, query_coord, rndata, g, t)
                     for g, t in zip(graphs, tgraphs)]
        return self.projection(self._combine_scales(per_scale, query_coord))
