"""The reference's arithmetic: float32 products with TF32 off, or on for
the control (the nearest precision below float32 that a product can take)."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def reference_precision(tf32: bool = False):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
