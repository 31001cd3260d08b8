"""UViT transformer processor.

Counterpart of ``gaot_tpu/models/transformer.py``: pre-RMSNorm blocks with
grouped-query attention, SwiGLU FFNs and UViT long-range skips
(encoder → decoder skip-concat + projection). Attention and the bf16 FFN go
through the hand-written kernels' wrappers (ops/cuda/), which launch the
kernel on a CUDA tensor and run the plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TransformerConfig
from ..ops.cuda import flash_attention as flash
from ..ops.cuda import fused_ffn as ffn_kernel
from ..utils.routing import record_route
from .mlp import Dense


class RMSNorm(nn.Module):
    """Root-mean-square norm: computed and scaled in fp32, returned in the
    input dtype (an fp32 weight must not upcast a bf16 residual stream)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
        return (normed * self.weight).to(x.dtype)


def apply_rope(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary positional embedding over the sequence axis of
    x [batch, seq, heads, head_dim], positions 0..seq-1."""
    _, seq, _, head_dim = x.shape
    half = head_dim // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    angles = torch.arange(seq, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if head_dim % 2:
        rotated = torch.cat([rotated, x[..., 2 * half:]], dim=-1)
    return rotated.to(x.dtype)


class GroupQueryAttention(nn.Module):
    """GQA attention block (q/k/v/o projections without bias)."""

    def __init__(self, input_size: int, hidden_size: int, num_heads: int = 8,
                 num_kv_heads: int = 8, backend: str = "auto",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if hidden_size % num_heads or num_heads % num_kv_heads:
            raise ValueError("hidden_size % num_heads and num_heads % "
                             "num_kv_heads must be 0")
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = hidden_size // num_heads
        self.backend = backend
        kv_hidden = self.head_dim * num_kv_heads
        mk = lambda i, o: Dense(i, o, bias=False, compute_dtype=dtype, device=device)
        self.q_proj = mk(input_size, hidden_size)
        self.k_proj = mk(input_size, kv_hidden)
        self.v_proj = mk(input_size, kv_hidden)
        self.o_proj = mk(hidden_size, input_size)

    def forward(self, x: torch.Tensor, use_rope: bool = False) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        if use_rope:
            q, k = apply_rope(q), apply_rope(k)
        # "auto"/"pallas": the flash kernel's wrapper, which launches the
        # kernel on a CUDA tensor (and raises on a head dim it was not built
        # for) and runs the plain version on a CPU tensor; "xla": the plain
        # version.
        if self.backend == "xla":
            record_route("attn", "plain")
            out = flash.attention_plain(q, k, v)
        else:
            record_route("attn", "cuda" if q.is_cuda else "plain")
            out = flash.flash_attention(q, k, v)
        return self.o_proj(out.reshape(b, s, -1))


class FFN(nn.Module):
    """SwiGLU feed-forward (w1, w3: hidden → ffn; w2: ffn → hidden)."""

    def __init__(self, input_size: int, ffn_hidden_size: int,
                 dtype: Optional[torch.dtype] = None, fused: str = "auto",
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        mk = lambda i, o: Dense(i, o, bias=False, compute_dtype=dtype, device=device)
        self.w1 = mk(input_size, ffn_hidden_size)
        self.w3 = mk(input_size, ffn_hidden_size)
        self.w2 = mk(ffn_hidden_size, input_size)

    def _use_fused(self, x: torch.Tensor) -> bool:
        """The fused SwiGLU kernel's wrapper serves bf16 compute under "auto"
        and every call under "on"; on a CUDA tensor it launches the kernel
        or raises on a width it was not built for. fp32 under "auto", and
        "off", take the plain three-product path, as the JAX package leaves
        them to XLA."""
        if self.fused == "on":
            return True
        return (self.fused == "auto" and self.dtype == torch.bfloat16
                and x.dtype == torch.bfloat16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._use_fused(x):
            record_route("ffn", "cuda" if x.is_cuda else "plain-fused")
            dt = x.dtype
            out = ffn_kernel.fused_ffn(
                x.reshape(-1, x.shape[-1]).contiguous(), self.w1.weight.to(dt),
                self.w3.weight.to(dt), self.w2.weight.to(dt).contiguous())
            return out.view(x.shape)
        record_route("ffn", "plain")
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class TransformerBlock(nn.Module):
    """Pre-norm block with an optional UViT skip input."""

    def __init__(self, config: TransformerConfig, skip_connection: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        cfg = config
        if cfg.attn_config.use_conditional_norm:
            raise NotImplementedError("time-conditional norm is not ported")
        h = cfg.hidden_size
        self.skip_proj = (Dense(2 * h, h, compute_dtype=dtype, device=device)
                          if skip_connection and cfg.use_long_range_skip else None)
        self.attn_norm = RMSNorm(h, cfg.norm_eps, device) if cfg.use_attn_norm else None
        self.attn = GroupQueryAttention(
            h, h, cfg.attn_config.num_heads, cfg.attn_config.num_kv_heads,
            backend=cfg.attn_backend, dtype=dtype, device=device)
        self.ffn_norm = RMSNorm(h, cfg.norm_eps, device) if cfg.use_ffn_norm else None
        self.ffn = FFN(h, h * cfg.ffn_multiplier, dtype=dtype,
                       fused=cfg.fused_ffn, device=device)

    def forward(self, x, use_rope: bool = False, skip=None):
        if self.skip_proj is not None and skip is not None:
            x = self.skip_proj(torch.cat([x, skip], dim=-1))
        h = self.attn_norm(x) if self.attn_norm is not None else x
        h = x + self.attn(h, use_rope=use_rope)
        # The reference's FFN residual branches off the NORMED activation:
        # out = norm(h) + ffn(norm(h)), kept for weight-level parity.
        h = self.ffn_norm(h) if self.ffn_norm is not None else h
        return h + self.ffn(h)


class Transformer(nn.Module):
    """UViT encoder/middle/decoder stack with long-range skips."""

    def __init__(self, input_size: int, output_size: int,
                 config: TransformerConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        cfg = self.config = config
        h = cfg.hidden_size
        self.input_proj = (Dense(input_size, h, compute_dtype=dtype, device=device)
                           if input_size != h else None)
        self.output_proj = (Dense(h, output_size, compute_dtype=dtype, device=device)
                            if h != output_size else None)
        n_half = cfg.num_layers // 2
        self.encoder_layers = nn.ModuleList(
            TransformerBlock(cfg, dtype=dtype, device=device) for _ in range(n_half))
        self.middle_layer = (TransformerBlock(cfg, dtype=dtype, device=device)
                             if cfg.num_layers % 2 == 1 else None)
        self.decoder_layers = nn.ModuleList(
            TransformerBlock(cfg, skip_connection=True, dtype=dtype, device=device)
            for _ in range(n_half))

    def forward(self, x: torch.Tensor, use_rope: bool = False) -> torch.Tensor:
        if self.input_proj is not None:
            x = self.input_proj(x)
        skips = []
        for block in self.encoder_layers:
            x = block(x, use_rope=use_rope)
            skips.append(x)
        if self.middle_layer is not None:
            x = self.middle_layer(x, use_rope=use_rope)
        for block in self.decoder_layers:
            skip = skips.pop() if self.config.use_long_range_skip else None
            x = block(x, use_rope=use_rope, skip=skip)
        if self.output_proj is not None:
            x = self.output_proj(x)
        return x
