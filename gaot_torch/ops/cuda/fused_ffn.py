"""Fused SwiGLU forward: out = (silu(x·W1ᵀ) ⊙ (x·W3ᵀ))·W2ᵀ.

Replaces ``gaot_tpu/ops/pallas/fused_ffn.py::_ffn_call`` (kernel body
``_fwd_kernel``), the UViT feed-forward in bf16 compute: once per layer on
the fx main path (R = B·S = 65536 rows, M = 256, F = 1024).

Bound on the H100: the tensor cores. The three products do 6·R·M·F
operations while the kernel moves only x, out and the weights; left to three
library products, each [R, F] intermediate would make a round trip through
device memory.

Design (``gaot_torch/csrc/fused_ffn.cu``): one block per 64-row tile of x,
four warps of 16 rows. The x tile stays in shared memory; the block walks F
in chunks of 32: each chunk computes h1 and h3 for its rows on the tensor
cores (``mma.sync`` m16n8k16, bf16 operands, fp32 accumulation), forms
z = silu(h1)·h3 rounded to bf16 in registers — the accumulator layout of one
product is the operand layout of the next — and accumulates out += z·W2ᵀ
in fp32 registers. h1, h3 and z never touch device memory. Ragged R is
masked (the TPU pads rows instead). The weights are taken in torch's Linear
layout: w1, w3 [F, M] and w2 [M, F], which are the column-major operands
``mma.sync`` wants. bf16 only; M must be 256 (the UViT hidden size of the
configurations the port runs) and F a multiple of 32.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

KERNEL_NAME = "fused_ffn_fwd"
launches = 0

M_BUILT = (256,)
F_CHUNK = 32


def fused_ffn_plain(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, with the kernel's numerics (the JAX
    package's ``reference_fused_ffn``): exact products of the x.dtype
    operands accumulated in fp32, silu·mul in fp32, z rounded to x.dtype.

    x: [R, M]; w1, w3: [F, M]; w2: [M, F]. Returns [R, M] in x.dtype."""
    h1 = F.linear(x.float(), w1.float())
    h3 = F.linear(x.float(), w3.float())
    z = (F.silu(h1) * h3).to(x.dtype)
    return F.linear(z.float(), w2.float()).to(x.dtype)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN with on-chip intermediates. x: [R, M] contiguous;
    w1, w3: [F, M]; w2: [M, F] (contiguous, x's dtype). Returns [R, M].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    r, m = x.shape
    f = w1.shape[0]
    if w1.shape != (f, m) or w3.shape != (f, m) or w2.shape != (m, f):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w3 {tuple(w3.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, w3, w2)
    if x.dtype != torch.bfloat16 or any(w.dtype != x.dtype for w in (w1, w3, w2)):
        raise TypeError(f"fused_ffn kernel takes bf16 only, got {x.dtype}")
    if m not in M_BUILT or f % F_CHUNK:
        raise ValueError(f"fused_ffn kernel is built for M in {M_BUILT} and "
                         f"F % {F_CHUNK} == 0, got M={m}, F={f}")
    if any(t.device != x.device for t in (w1, w3, w2)):
        raise ValueError("x and the weights must be on the same device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w1, w3, w2)):
        raise ValueError("fused_ffn takes contiguous, 16-byte aligned tensors")
    from .build import check, load, refuse_grad

    refuse_grad(x, w1, w3, w2)

    global launches
    out = torch.empty_like(x)
    if r == 0:
        return out
    lib = load("fused_ffn")
    fn = lib.gaot_fused_ffn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            out.data_ptr(), r, m, f, stream)
    check(rc, "fused_ffn")
    launches += 1
    return out
