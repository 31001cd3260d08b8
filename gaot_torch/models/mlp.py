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
    Flax Dense default), normal(0.01) weights in a :class:`ConditionedNorm`
    (``correction``), zero biases, unit norm scales. Values are drawn on
    the CPU from ``generator`` and copied, so a seed gives the same weights
    on every device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif ".correction." in f".{name}":
                p.copy_(0.01 * torch.randn(p.shape, generator=generator))
            else:
                fan_in = p.shape[1] * (p.shape[2] if p.dim() == 3 else 1)
                w = torch.randn(p.shape, generator=generator) / fan_in ** 0.5
                p.copy_(w)


class _SimpleMLP(nn.Module):
    """The reference ``MLP(num_layers=2)``: one Linear in a ModuleList
    (``layers.0``), as ``gaot_tpu/models/mlp.py::SimpleMLP`` at two layers."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [Dense(in_features, out_features, compute_dtype=dtype, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[0](x)


class ConditionedNorm(nn.Module):
    """Time-conditioned scale and bias, ``x·(1 + c·S(c)) + c·B(c)``
    (``gaot_tpu/models/mlp.py::ConditionedNorm``). c: [B, 1], x: [B, S, F].
    S and B (``mlp_scale``, ``mlp_bias``) start from normal(0.01) weights
    and zero biases, so the correction starts near the identity; their
    values are drawn by :func:`init_parameters` from the model's generator.
    The products promote as in the JAX package: a bf16 x times the fp32
    scale of an fp32 condition is fp32."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.mlp_scale = _SimpleMLP(1, features, dtype=dtype, device=device)
        self.mlp_bias = _SimpleMLP(1, features, dtype=dtype, device=device)

    def forward(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        scale = 1.0 + c * self.mlp_scale(c)
        bias = c * self.mlp_bias(c)
        return x * scale[:, None, :] + bias[:, None, :]
