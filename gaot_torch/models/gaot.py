"""GAOT — Geometry-Aware Operator Transformer.

Counterpart of ``gaot_tpu/models/gaot.py``: a MAGNO encoder maps scattered
physical-node features onto a regular latent grid, a patchified UViT
transformer evolves the latent grid, and a MAGNO decoder maps back to the
query points. Patchify/unpatchify keep the reference's element order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.config import ModelConfig
from ..parallel import comm
from .magno import MAGNODecoder, MAGNOEncoder
from .mlp import Dense, init_parameters
from .transformer import GroupQueryAttention, Transformer


def patch_positions(grid_shape: Sequence[int], patch_size: int) -> np.ndarray:
    """Integer patch-grid positions [num_patches, ndim]."""
    counts = [s // patch_size for s in grid_shape]
    mesh = np.meshgrid(*[np.arange(c, dtype=np.float32) for c in counts], indexing="ij")
    return np.stack(mesh, axis=-1).reshape(-1, len(counts))


def absolute_embeddings(positions: np.ndarray, embed_dim: int) -> np.ndarray:
    """Sinusoidal absolute positional embeddings [num_patches, embed_dim]."""
    num_pos_dims = positions.shape[1]
    dim_touse = embed_dim // (2 * num_pos_dims)
    freq_seq = np.arange(dim_touse, dtype=np.float32)
    inv_freq = 1.0 / (10000 ** (freq_seq / dim_touse))
    sinusoid = positions[:, :, None] * inv_freq[None, None, :]
    emb = np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
    emb = emb.reshape(positions.shape[0], -1)
    if emb.shape[1] < embed_dim:
        emb = np.pad(emb, ((0, 0), (0, embed_dim - emb.shape[1])))
    return emb


def patchify(x: torch.Tensor, grid_shape: Sequence[int], patch_size: int) -> torch.Tensor:
    """[B, prod(grid), C] → [B, num_patches, P^ndim · C] (reference order)."""
    b, _, c = x.shape
    p = patch_size
    if len(grid_shape) == 2:
        h, w = grid_shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c)
    h, w, d = grid_shape
    x = x.reshape(b, h // p, p, w // p, p, d // p, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (h // p) * (w // p) * (d // p), p * p * p * c)


def unpatchify(x: torch.Tensor, grid_shape: Sequence[int], patch_size: int,
               channels: int) -> torch.Tensor:
    """Inverse of patchify: [B, num_patches, P^ndim · C] → [B, prod(grid), C]."""
    b = x.shape[0]
    p = patch_size
    if len(grid_shape) == 2:
        h, w = grid_shape
        x = x.reshape(b, h // p, w // p, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h * w, channels)
    h, w, d = grid_shape
    x = x.reshape(b, h // p, w // p, d // p, p, p, p, channels)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, h * w * d, channels)


class GAOT(nn.Module):
    """The GAOT model (fx coordinates, evaluation forward).

    Parameters carry the original PyTorch GAOT ``state_dict`` names.
    ``dtype`` is the compute dtype (None = fp32; parameters stay fp32).
    The weights are drawn from ``generator`` (seed 0 when None) on the CPU
    and placed on ``device``."""

    def __init__(self, input_size: int, output_size: int, config: ModelConfig,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        magno, tcfg = cfg.args.magno, cfg.args.transformer
        self.grid_shape = tuple(cfg.latent_tokens_size)
        if len(self.grid_shape) != magno.coord_dim:
            raise ValueError(f"latent_tokens_size {self.grid_shape} must have "
                             f"{magno.coord_dim} dims")
        self.patch_size = tcfg.patch_size
        if any(s % self.patch_size for s in self.grid_shape):
            raise ValueError(f"grid {self.grid_shape} not divisible by patch "
                             f"{self.patch_size}")
        self.node_latent_size = magno.lifting_channels
        self.use_rope = tcfg.positional_embedding == "rope"
        embed_dim = self.patch_size ** magno.coord_dim * self.node_latent_size

        self.encoder = MAGNOEncoder(input_size, self.node_latent_size, magno,
                                    self.node_latent_size, dtype=dtype, device=device)
        self.patch_linear = Dense(embed_dim, embed_dim, compute_dtype=dtype,
                                  device=device)
        self.processor = Transformer(embed_dim, embed_dim, tcfg, dtype=dtype,
                                     device=device)
        self.decoder = MAGNODecoder(self.node_latent_size, output_size, magno,
                                    self.node_latent_size, dtype=dtype, device=device)
        pos = absolute_embeddings(patch_positions(self.grid_shape, self.patch_size),
                                  embed_dim)
        self.register_buffer("pos_emb", torch.from_numpy(pos).to(device),
                             persistent=False)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.spatial = None

    def shard_queries(self, shard) -> None:
        """Spatial parallelism (``parallel/spatial.py``): from here on the
        forward computes ``shard``'s latent queries, tokens and output
        queries; the caller gives it the encoder and decoder graphs whose
        rows are those ranges (``spatial.cut_rows``)."""
        self.spatial = shard
        for mod in self.processor.modules():
            if isinstance(mod, GroupQueryAttention):
                mod.sp = (shard.group, shard.tokens)
        for mod in (self.encoder, self.decoder):
            if mod.config.use_geoembed:
                mod.geoembed.group = shard.group

    def process(self, rndata: torch.Tensor,
                condition: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """UViT over patch tokens; ``condition`` [B, 1] feeds the
        conditional norms, ``generator`` draws the attention dropout."""
        c = rndata.shape[-1]
        sp = self.spatial
        grid = self.grid_shape if sp is None else sp.grid
        tokens = self.patch_linear(patchify(rndata, grid, self.patch_size))
        if not self.use_rope:
            pos = self.pos_emb if sp is None else self.pos_emb[sp.tokens[0]:sp.tokens[1]]
            tokens = tokens + pos.to(tokens.dtype)
        tokens = self.processor(tokens, use_rope=self.use_rope, condition=condition,
                                generator=generator)
        return unpatchify(tokens, grid, self.patch_size, c)

    def forward(self, latent_tokens_coord, xcoord, pndata, encoder_graphs,
                decoder_graphs, query_coord=None, encoder_tgraphs=None,
                decoder_tgraphs=None, condition=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """latent_tokens_coord [Q, d]; xcoord [N, d]; pndata [B, N, Cin];
        graphs: per-scale graphs on the model's device; query_coord defaults
        to xcoord; ``condition`` [B, 1], the time condition of the
        processor's conditional norms (``attn_config.use_conditional_norm``).
        ``generator`` (a ``torch.Generator`` on the model's device) marks a
        training forward: it draws the edge drop (``magno.sampling_strategy``)
        and the attention dropout (``atten_dropout``), in that order: the
        encoder's scales, the UViT's layers, the decoder's scales. None
        (evaluation) drops nothing. Returns [B, M, Cout]; under spatial
        parallelism (:meth:`shard_queries`) this rank's output queries
        [B, M_rank, Cout]."""
        sp = self.spatial
        latent_enc = (latent_tokens_coord if sp is None
                      else latent_tokens_coord[sp.latent[0]:sp.latent[1]])
        rndata = self.encoder(xcoord, pndata, latent_enc,
                              encoder_graphs, tgraphs=encoder_tgraphs,
                              generator=generator)
        rndata = self.process(rndata, condition=condition, generator=generator)
        if query_coord is None:
            query_coord = xcoord
        if sp is not None:
            # The decoder reads the whole latent grid for its own queries.
            rndata = comm.gather_along(rndata, sp.group, 1)
            query_coord = query_coord[..., sp.nodes[0]:sp.nodes[1], :]
        return self.decoder(latent_tokens_coord, rndata, query_coord,
                            decoder_graphs, tgraphs=decoder_tgraphs,
                            generator=generator)
