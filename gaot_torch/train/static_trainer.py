"""Training and evaluation steps of the static (time-independent) trainer,
fx mode.

Counterpart of ``masked_mse`` and the jitted ``train_fn`` and ``eval_fn`` of
``gaot_tpu/train/static_trainer.py``. The trainer class, the data loader,
checkpoints and the CLI are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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


def _forward(model, graphs: FxGraphs, coord, pndata):
    return model(graphs.latent_tokens_coord, coord, pndata, graphs.encoder,
                 graphs.decoder, encoder_tgraphs=graphs.encoder_t,
                 decoder_tgraphs=graphs.decoder_t)


def train_step(model, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], step: int, graphs: FxGraphs,
               coord: torch.Tensor, pndata: torch.Tensor, target: torch.Tensor,
               sample_mask: torch.Tensor,
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One optimizer step on one batch: the forward in training mode, the
    masked MSE, its backward through the kernels' gradients, then the
    update with the learning rate ``schedule(step)`` (``step`` counts the
    updates from 0). Returns the loss (detached, fp32)."""
    if model.processor.config.attn_config.atten_dropout > 0:
        raise NotImplementedError("attention dropout is not ported")
    if model.encoder.config.sampling_strategy is not None:
        raise NotImplementedError("edge drop (sampling_strategy) is not ported")
    if not model.encoder.config.use_transpose_backward:
        raise NotImplementedError("training needs the transpose graphs "
                                  "(magno.use_transpose_backward)")
    model.train()
    loss = masked_mse(_forward(model, graphs, coord, pndata), target,
                      sample_mask, node_mask)
    loss.backward()
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


@torch.no_grad()
def eval_step(model, graphs: FxGraphs, coord: torch.Tensor, pndata: torch.Tensor,
              target: torch.Tensor, sample_mask: torch.Tensor,
              node_mask: Optional[torch.Tensor] = None):
    """One evaluation batch: (prediction [B, N, Cout], masked MSE)."""
    pred = _forward(model, graphs, coord, pndata)
    return pred, masked_mse(pred, target, sample_mask, node_mask)
