"""Fused SwiGLU: out = (silu(x·W1ᵀ) ⊙ (x·W3ᵀ))·W2ᵀ, forward and backward.

Replaces ``gaot_tpu/ops/pallas/fused_ffn.py::_ffn_call`` (kernel body
``_fwd_kernel``) and ``_ffn_bwd_call`` (``_bwd_kernel``), the UViT
feed-forward in bf16 compute: forward and backward once per layer on the fx
main path (R = B·S = 65536 rows, M = 256, F = 1024).

Bound on the H100: the tensor cores. The forward's three products do
6·R·M·F operations and the backward's (h1 and h3 recomputed, dz, dW1, dW3,
dW2, dx) 16·R·M·F, while the kernels move only x, dout, dx and the weights;
left to library products, each [R, F] intermediate would make a round trip
through device memory.

Forward design (``gaot_torch/csrc/fused_ffn.cu``): one block per 64-row
tile of x, four warps of 16 rows. The x tile stays in shared memory; the
block walks F in chunks of 32: each chunk computes h1 and h3 for its rows on
the tensor cores (``mma.sync`` m16n8k16, bf16 operands, fp32 accumulation),
forms z = silu(h1)·h3 rounded to bf16 in registers — the accumulator layout
of one product is the operand layout of the next — and accumulates
out += z·W2ᵀ in fp32 registers. h1, h3 and z never touch device memory.
Ragged R is masked (the TPU pads rows instead). The weights are taken in
torch's Linear layout: w1, w3 [F, M] and w2 [M, F], which are the
column-major operands ``mma.sync`` wants. bf16 only; M may be 128, 256, 384
or 512 (every width the JAX gate takes up to 512) and F a multiple of 32.
Above M = 256 a warp's fp32 output accumulator would pass the register
file, so the block has eight warps, each half of them owning half of the
output columns and recomputing h1 and h3 for its rows.

Backward design: the TPU kernel carries dW in VMEM across its sequential
grid; blocks on the card run in no order, so one backward call is three
launches of one entry point. A dx kernel (one block per 64-row tile) walks F
in chunks, recomputes h1, h3 and dz = dout·W2 for the chunk, rounds
dh1 = dz⊙h3⊙silu′(h1) and dh3 = dz⊙silu(h1) to bf16 and accumulates
dx += dh1·W1c + dh3·W3c. A dW kernel (one block per F chunk and row split)
recomputes the same chunk and sums dW1c, dW3c and dW2[:, c] over its rows in
fp32 registers into a per-split partial; a third pass sums the partials in a
fixed order, so the result is deterministic (no float atomics). Every tile
sits in shared memory in its natural layout, copied with ``cp.async`` into
double buffers while the previous tile computes; the products that need a
tile transposed (dz, dx, all three dW) load their fragments with
``ldmatrix.trans``. The tiles follow M so that each instantiation fits a
block's 227 KB: 64 rows up to M = 256, 32 rows above, and at M = 512 one
buffer instead of two. Transposing by element-wise shared stores instead put
all 32 lanes of a warp on one bank and cost 4× the time. The fp32
compute path keeps the plain three products, as the JAX package leaves it to
XLA, and its gradient is autograd's.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

launches = {"fused_ffn_fwd": 0, "fused_ffn_bwd": 0}

# The widths the kernels are instantiated for: every width the JAX gate takes
# (M % 128 == 0) up to 512.
M_BUILT = (128, 256, 384, 512)
F_CHUNK = 32


def supported(r: int, m: int, f: int, dtype) -> int:
    """The port's copy of the JAX package's gate
    ``gaot_tpu/ops/pallas/fused_ffn.py::supported``: the TPU kernel's row
    tile for R rows of width M and FFN width F, or 0 where the JAX package
    leaves the SwiGLU to XLA's three products (not bf16 or fp32, M or F not
    a multiple of 128, or weights and fp32 dW accumulators above 64 MiB).
    The FFN routes by this rule, so a width it accepts that the kernel was
    not built for (M above 512, not in ``M_BUILT``) still reaches the
    wrapper and raises on the card."""
    if dtype not in (torch.bfloat16, torch.float32) or m % 128 or f % 128:
        return 0
    per_row = f * 4 * 4 + m * 8          # fp32 h1, h3, dz (+ slack) per row
    budget = 6 << 20
    if (m * f * 3) * (2 + 4) > 64 << 20:
        return 0
    t = max(budget // per_row, 128) // 128 * 128
    return min(t, 2048)


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


def fused_ffn_bwd_plain(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                        w2: torch.Tensor, dout: torch.Tensor):
    """The plain backward, with the arithmetic of the TPU kernel's
    ``_bwd_kernel``: h1, h3 and dz = dout·W2 in fp32, dh1 and dh3 rounded to
    x.dtype, dx in x.dtype, and dW1, dW3, dW2 summed over all rows in fp32.

    Returns (dx [R, M], dw1 [F, M], dw3 [F, M], dw2 [M, F])."""
    xf = x.float()
    d = dout.to(x.dtype).float()
    h1 = F.linear(xf, w1.float())
    h3 = F.linear(xf, w3.float())
    sg = torch.sigmoid(h1)
    z = (h1 * sg * h3).to(x.dtype).float()
    dz = d @ w2.float()                                      # [R, F]
    dh1 = (dz * h3 * (sg * (1.0 + h1 * (1.0 - sg)))).to(x.dtype).float()
    dh3 = (dz * h1 * sg).to(x.dtype).float()
    dx = (dh1 @ w1.float() + dh3 @ w3.float()).to(x.dtype)
    return dx, dh1.t() @ xf, dh3.t() @ xf, d.t() @ z


def _check(x, w1, w3, w2):
    r, m = x.shape
    f = w1.shape[0]
    if w1.shape != (f, m) or w3.shape != (f, m) or w2.shape != (m, f):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w3 {tuple(w3.shape)}, "
                         f"w2 {tuple(w2.shape)}")


def _check_kernel_inputs(*ts):
    x = ts[0]
    m, f = x.shape[1], ts[1].shape[0]
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"fused_ffn kernel takes bf16 only, got {x.dtype}")
    if m not in M_BUILT or f % F_CHUNK:
        raise ValueError(f"fused_ffn kernel is built for M in {M_BUILT} and "
                         f"F % {F_CHUNK} == 0, got M={m}, F={f}")
    if any(t.device != x.device for t in ts):
        raise ValueError("x and the weights must be on the same device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("fused_ffn takes contiguous, 16-byte aligned tensors")


def _forward_kernel(x, w1, w3, w2):
    _check_kernel_inputs(x, w1, w3, w2)
    from .build import check, entry

    r, m = x.shape
    out = torch.empty_like(x)
    if r == 0:
        return out
    fn = entry("fused_ffn", "gaot_fused_ffn_fwd",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            out.data_ptr(), r, m, w1.shape[0], stream)
    check(rc, "fused_ffn")
    launches["fused_ffn_fwd"] += 1
    return out


def _forward(x, w1, w3, w2):
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, w3, w2)
    return _forward_kernel(x, w1, w3, w2)


def fused_ffn_bwd(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor, dout: torch.Tensor):
    """(dx in x.dtype, dw1, dw3, dw2 in fp32) of the fused SwiGLU. CPU
    tensors take the plain backward; CUDA tensors launch the backward
    kernels (dx, per-split dW partials, their fixed-order sum)."""
    _check(x, w1, w3, w2)
    if dout.shape != x.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_ffn_bwd_plain(x, w1, w3, w2, dout)
    dout = dout.to(x.dtype).contiguous()
    _check_kernel_inputs(x, w1, w3, w2, dout)
    from .build import check, entry

    r, m = x.shape
    f = w1.shape[0]
    dx = torch.empty_like(x)
    dw = torch.empty((3, f * m), dtype=torch.float32, device=x.device)
    views = (dx, dw[0].view(f, m), dw[1].view(f, m), dw[2].view(m, f))
    if r == 0:
        dw.zero_()
        return views
    row_tile = entry("fused_ffn", "gaot_fused_ffn_bwd_row_tile", [ctypes.c_int])(m)
    tiles = -(-r // row_tile)
    # Two waves of (F chunk, row split) blocks, one block per SM.
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(tiles, 2 * sms // (f // F_CHUNK)))
    part = torch.empty((splits, 3 * f * m), dtype=torch.float32, device=x.device)
    fn = entry("fused_ffn", "gaot_fused_ffn_bwd",
               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), part.data_ptr(), dw.data_ptr(),
            r, m, f, splits, stream)
    check(rc, "fused_ffn_bwd")
    launches["fused_ffn_bwd"] += 1
    return views


class _FusedFFN(torch.autograd.Function):
    """SwiGLU whose gradient is the backward kernel (the plain backward on
    CPU tensors). Saves x and the weights; h1, h3 and z are recomputed."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2):
        ctx.save_for_backward(x, w1, w3, w2)
        return _forward(x, w1, w3, w2)

    @staticmethod
    def backward(ctx, dout):
        x, w1, w3, w2 = ctx.saved_tensors
        dx, dw1, dw3, dw2 = fused_ffn_bwd(x, w1, w3, w2, dout)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                dw1.to(w1.dtype) if need[1] else None,
                dw3.to(w3.dtype) if need[2] else None,
                dw2.to(w2.dtype) if need[3] else None)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN with on-chip intermediates. x: [R, M] contiguous;
    w1, w3: [F, M]; w2: [M, F] (contiguous, x's dtype). Returns [R, M].
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Where a gradient is needed the call is differentiable through
    :func:`fused_ffn_bwd`."""
    _check(x, w1, w3, w2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w3, w2)):
        return _FusedFFN.apply(x, w1, w3, w2)
    return _forward(x, w1, w3, w2)
