"""Masked neighborhood reductions over a static K axis.

Counterparts of ``gaot_tpu/ops/segment_ops.py``: ragged CSR rows are padded
``[Q, K]`` windows, so every reduction is a dense masked reduce.
"""
from __future__ import annotations

import torch


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.unsqueeze(-1) if mask.dim() == x.dim() - 1 else mask


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Sum over the K axis with padded entries zeroed. mask broadcasts to x."""
    return torch.where(_expand(mask, x), x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device)).sum(dim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Mean over valid entries of the K axis; empty rows yield 0."""
    m = _expand(mask, x)
    total = torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(dim)
    count = m.sum(dim).clamp(min=1)
    return total / count


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Max over valid entries of the K axis; empty rows yield 0."""
    m = _expand(mask, x)
    neg = torch.finfo(x.dtype).min
    maxed = torch.where(m, x, torch.full((), neg, dtype=x.dtype,
                                         device=x.device)).amax(dim)
    return torch.where(m.any(dim), maxed, torch.zeros_like(maxed))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Numerically stable softmax over the K axis restricted to valid
    entries. Padded entries get weight 0; empty rows return all zeros."""
    neg = torch.finfo(scores.dtype).min
    shifted = torch.where(mask, scores, torch.full((), neg, dtype=scores.dtype,
                                                   device=scores.device))
    maxes = shifted.amax(dim, keepdim=True)
    maxes = torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))
    ex = torch.where(mask, torch.exp(torch.where(mask, scores, maxes) - maxes),
                     torch.zeros((), dtype=scores.dtype, device=scores.device))
    denom = ex.sum(dim, keepdim=True)
    return ex / denom.clamp(min=torch.finfo(scores.dtype).tiny)
