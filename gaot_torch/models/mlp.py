"""MLP building blocks.

Counterparts of ``gaot_tpu/models/mlp.py``. Every layer computes in an
optional ``compute_dtype`` (the JAX package's Flax ``dtype``): inputs and
fp32 parameters are cast to it before the product; with None the layer
computes in the promoted dtype of its input and parameters. Parameter names
and shapes are the original PyTorch GAOT's (``ChannelMLP`` layers are 1x1
Conv1d weights ``[out, in, 1]``), so a JAX checkpoint loads strictly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def gelu_auto(x: torch.Tensor) -> torch.Tensor:
    """GELU whose branch follows the compute dtype: exact erf GELU in fp32,
    the tanh approximation in bf16 (as ``gaot_tpu/models/mlp.py::_gelu_auto``)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def _compute_dtype(x: torch.Tensor, w: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` over the trailing axis, computing in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.compute_dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class PointwiseConv(nn.Conv1d):
    """A 1x1 ``nn.Conv1d`` (weight ``[out, in, 1]``) applied over the
    trailing channel axis of a channels-last tensor."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(in_channels, out_channels, 1, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.compute_dtype)
        return F.linear(x.to(dt), self.weight[..., 0].to(dt), self.bias.to(dt))


class LinearChannelMLP(nn.Module):
    """Dense stack (``fcs.i``), ``features[i]`` outputs per layer, GELU
    between layers."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        widths = [in_features, *features]
        self.fcs = nn.ModuleList(
            Dense(a, b, compute_dtype=dtype, device=device)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < len(self.fcs) - 1:
                x = gelu_auto(x)
        return x


class ChannelMLP(nn.Module):
    """Pointwise channel MLP: ``n_layers`` 1x1 convolutions (``fcs.i``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: Optional[int] = None, n_layers: int = 2,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        hidden = hidden_channels or out_channels
        widths = [in_channels] + [hidden] * (n_layers - 1) + [out_channels]
        self.fcs = nn.ModuleList(
            PointwiseConv(a, b, compute_dtype=dtype, device=device)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < len(self.fcs) - 1:
                x = gelu_auto(x)
        return x


class ScaleWeightMLP(nn.Sequential):
    """Learned multiscale weights: Linear → ReLU → Linear (names ``0``, ``2``)."""

    def __init__(self, in_features: int, num_scales: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(
            Dense(in_features, hidden_size, compute_dtype=dtype, device=device),
            nn.ReLU(),
            Dense(hidden_size, num_scales, compute_dtype=dtype, device=device))


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: LeCun-normal weights (std 1/sqrt(fan_in), the
    Flax Dense default), zero biases, unit norm scales. Values are drawn on
    the CPU from ``generator`` and copied, so a seed gives the same weights
    on every device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                fan_in = p.shape[1] * (p.shape[2] if p.dim() == 3 else 1)
                w = torch.randn(p.shape, generator=generator) / fan_in ** 0.5
                p.copy_(w)
