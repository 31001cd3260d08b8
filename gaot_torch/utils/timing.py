"""Execution barrier for host clocks.

Counterpart of ``gaot_tpu/utils/timing.py``. CUDA calls return before the
device has run them, so a host clock stopped right after them measures the
time to queue the work, not to do it. :func:`force_value` waits for every
kernel queued on the device before it returns, so a clock stopped after it
counts the device's work.
"""
from __future__ import annotations

import torch


def force_value(x: torch.Tensor) -> float:
    """Wait for the device's queued work (``torch.cuda.synchronize``; on
    the CPU there is nothing to wait for), then fetch the last element of
    ``x``."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.detach().reshape(-1)[-1])
