"""The uniform draws of the training regularisers (edge drop, attention
dropout), from a ``torch.Generator`` or from a :class:`BatchShare` of one.

A data-parallel rank holds a share of the global batch. So that it draws
what one process draws for its samples, and its generator moves as one
process's does, it draws the global batch's numbers and keeps its own
samples' rows: the trainer's step passes a :class:`BatchShare` where it
would pass the generator.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class BatchShare(NamedTuple):
    """``generator``, whose per-sample draws are made for ``total`` samples
    and of which the caller's samples begin at sample ``offset``."""

    generator: torch.Generator
    offset: int
    total: int


Draws = Union[torch.Generator, BatchShare, torch.Tensor]


def uniform(shape, draws: Draws, device, samples: Optional[int] = None) -> torch.Tensor:
    """``torch.rand(shape)`` for a tensor whose leading axis holds
    ``samples`` samples' rows, sample-major (None: no sample axis, the draw
    shared by the batch). From a :class:`BatchShare` the draw is the global
    batch's, of which the caller's samples' rows are kept; a tensor is a
    draw already made, of this shape, and returns as it is."""
    if isinstance(draws, torch.Tensor):
        if tuple(draws.shape) != tuple(shape):
            raise ValueError(f"uniforms of shape {tuple(draws.shape)} for a draw of "
                             f"{tuple(shape)}")
        return draws
    if not isinstance(draws, BatchShare):
        return torch.rand(shape, generator=draws, device=device)
    if samples is None or draws.total == samples:
        return torch.rand(shape, generator=draws.generator, device=device)
    per = shape[0] // samples
    u = torch.rand((per * draws.total, *shape[1:]), generator=draws.generator,
                   device=device)
    return u.narrow(0, per * draws.offset, shape[0])
