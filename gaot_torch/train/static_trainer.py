"""Evaluation step of the static (time-independent) trainer, fx mode.

Counterpart of ``masked_mse`` and the jitted ``eval_fn`` of
``gaot_tpu/train/static_trainer.py``. The training step, the trainer class,
the data loader and the CLI are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class FxGraphs(NamedTuple):
    """The fx model's graph arguments, all on the model's device."""

    latent_tokens_coord: torch.Tensor
    encoder: list
    decoder: list
    encoder_t: Optional[list] = None
    decoder_t: Optional[list] = None


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               sample_mask: torch.Tensor,
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE over valid (sample, node) entries, in fp32."""
    err = (pred.float() - target.float()) ** 2
    w = sample_mask.float()[:, None, None]
    if node_mask is not None:
        w = w * node_mask.float()[..., None]
    w = w.expand(err.shape)
    return (err * w).sum() / w.sum().clamp(min=1.0)


@torch.no_grad()
def eval_step(model, graphs: FxGraphs, coord: torch.Tensor, pndata: torch.Tensor,
              target: torch.Tensor, sample_mask: torch.Tensor,
              node_mask: Optional[torch.Tensor] = None):
    """One evaluation batch: (prediction [B, N, Cout], masked MSE)."""
    pred = model(graphs.latent_tokens_coord, coord, pndata, graphs.encoder,
                 graphs.decoder, encoder_tgraphs=graphs.encoder_t,
                 decoder_tgraphs=graphs.decoder_t)
    return pred, masked_mse(pred, target, sample_mask, node_mask)
