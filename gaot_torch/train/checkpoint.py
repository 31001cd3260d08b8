"""Training checkpoints: one ``torch.save`` file in place of Orbax.

Counterpart of ``gaot_tpu/train/checkpoint.py``. The file holds the model's
``state_dict`` (whose keys are the original PyTorch GAOT's), the
optimizer's ``state_dict`` and the update count. In the JAX package the
schedule's position is optax's ``count`` inside the optimizer state; here
the trainer's own update counter feeds the schedule, so it is saved and
restored with the weights, or a resumed run would restart the learning-rate
schedule.
"""
from __future__ import annotations

import os
from typing import Dict

import torch


def checkpoint_file(path: str) -> str:
    """The file a checkpoint path names: ``<path>.pt`` (the JAX package
    writes an Orbax directory at ``<path>``)."""
    return f"{path}.pt"


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int) -> str:
    """Write the model, the optimizer and the update count; returns the file."""
    fname = checkpoint_file(os.path.abspath(path))
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    tmp = f"{fname}.{os.getpid()}.tmp"
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step)}, tmp)
    os.replace(tmp, fname)
    return fname


def load_checkpoint(path: str, device) -> Dict:
    """Read a file written by :func:`save_checkpoint`, tensors on ``device``."""
    return torch.load(checkpoint_file(os.path.abspath(path)), map_location=device,
                      weights_only=True)
