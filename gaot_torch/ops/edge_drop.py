"""Edge drop (neighbour sampling) as a dropout of the padded K axis's mask.

Counterpart of ``gaot_tpu/ops/edge_drop.py``, a training-only
regularisation:

- ``ratio``: each edge kept on its own with probability ``sample_ratio``;
- ``max_neighbors``: each query keeps a uniformly random subset of at most
  ``max_neighbors`` of its edges: a uniform score in [0, 1) for each valid
  edge and −1 for each padding slot, the slots scoring at least the row's
  ``max_neighbors``-th largest score kept (ties keep more; a row with fewer
  valid edges keeps them all).

The draw comes from a ``torch.Generator`` on the mask's device and the mask
stays on the device: no value is read back to the host. A new contiguous
bool mask is returned, since the multiply-reduce kernel reads masks as
bytes; the mask given is never written, so graphs placed once on the device
(fx, and the vx layout) stay as they were built.
"""
from __future__ import annotations

from typing import Optional

import torch


def apply_edge_drop_mask(mask: torch.Tensor, generator: Optional[torch.Generator],
                         strategy: Optional[str], max_neighbors: Optional[int] = None,
                         sample_ratio: Optional[float] = None) -> torch.Tensor:
    """The thinned neighbour mask of ``mask`` (bool [..., Q, K]). Without a
    generator or a strategy, with a ratio of 1 or more, or where K is at
    most ``max_neighbors``, nothing is drawn and ``mask`` itself returns."""
    if generator is None or strategy is None:
        return mask
    if strategy == "ratio":
        if sample_ratio is None or sample_ratio >= 1.0:
            return mask
        keep = torch.rand(mask.shape, generator=generator, device=mask.device)
        return mask & (keep < sample_ratio)
    if strategy == "max_neighbors":
        if max_neighbors is None or max_neighbors >= mask.shape[-1]:
            return mask
        scores = torch.rand(mask.shape, generator=generator, device=mask.device)
        scores = torch.where(mask, scores, -1.0)
        kth = torch.topk(scores, max_neighbors, dim=-1, sorted=True).values[..., -1:]
        return mask & (scores >= kth)
    raise ValueError(f"Unknown sampling strategy: {strategy}")
