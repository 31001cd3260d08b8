"""Fused SwiGLU: out = (silu(x·W1ᵀ) ⊙ (x·W3ᵀ))·W2ᵀ, forward and backward.

Replaces ``gaot_tpu/ops/pallas/fused_ffn.py::_ffn_call`` (kernel body
``_fwd_kernel``) and ``_ffn_bwd_call`` (``_bwd_kernel``), the UViT
feed-forward in bf16 compute: forward and backward once per layer on the fx
main path (R = B·S = 65536 rows, M = 256, F = 1024).

Bound on the H100: the tensor cores. The forward's three products do
6·R·M·F operations and the backward's (h1, h3, dz, dx, dW1, dW3, dW2)
16·R·M·F; at the fx shape x, out and the weights move in a fifth of the
forward products' time.

Design (``gaot_torch/csrc/fused_ffn.cu``; its head comment has the detail),
every bf16 product on ``wgmma`` with operands read from shared memory, in
its swizzled layouts, as they lie in device memory (K-major or MN-major), so
no transposed copy:

- Forward at M = 128 and 256 (bf16): one fused kernel. A block's 128 rows
  of x stay in shared memory, the W1/W3 rows and W2 columns of each F chunk
  stream through a three-stage ring, each stage filled by one bulk copy of
  the chunk's image (the weights packed into the stages' layout by a first
  kernel into the scratch); two warpgroups own 64
  rows each, with the whole 64 × M fp32 output in registers and
  z = silu(h1)·h3 formed in registers as the A fragment of z·W2ᵀ.
- Backward at M = 128 and 256 (bf16): a row kernel of the same shape, with
  dout resident beside x and the same packed ring, computes h1, h3 and
  dz = dout·W2 once per chunk,
  stores dh1 | dh3 ([R, 2F]) and z ([R, F]) in bf16 and accumulates
  dx = [dh1 dh3]·[W1; W3] in registers; one GEMM launch then gives
  dW1 | dW3 = [dh1 dh3]ᵀ·x and dW2 = doutᵀ·z, split over the rows into fp32
  partials summed in a fixed order (deterministic, no float atomics).
  16·R·M·F operations, no recompute; the intermediates make one round trip
  through device memory.
- Every other width the JAX gate takes (M % 128 == 0, F % 128 == 0; at 384
  and above a warpgroup's fp32 output passes its registers), bf16: one
  warp-specialized, persistent kernel skeleton. A producer warpgroup keeps a
  ring of shared-memory stages full by TMA, counted on mbarriers; two
  consumer warpgroups run the products on ``wgmma`` as the stages land; one
  block an SM walks the tiles. Its producer mode writes z (forward, 128 × 128
  tiles of [R, F]) or dh1 | dh3 and z (backward, 128 × 64 tiles, with dz) to
  a scratch; its GEMM mode does the rest: z·W2ᵀ (2 launches a forward), or
  the weight gradients' row-split partials and dx in one launch, then their
  fixed-order sum (3 launches a backward).
- fp32 (every M): every product on the tensor cores as split TF32, each
  fp32 operand held as hi = tf32(x) and lo = tf32(x − hi) and each product
  as lo·hi + hi·lo + hi·hi (three tf32 ``wgmma``s, fp32 accumulators, a
  fresh one per 32 of K added to the running sums in fp32), which keeps
  fp32's accuracy with TF32 off, the SwiGLU itself in fp32, as the Pallas
  kernel computes in x.dtype. A tf32 ``wgmma`` reads both operands K-major,
  so a producer writes z (forward) or dh1 | dh3, and their transposes with
  z's (backward), and one GEMM with runtime shapes does the rest: two
  launches forward; four backward (the weights, x and dout transposed in
  device memory, the producer, dx with the weight gradients' row-split
  partials, their fixed-order sum).

The TPU kernel pads R to its row tile; here ragged R is masked. The
weights are taken in torch's Linear layout: w1, w3 [F, M] and w2 [M, F].
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

launches = {"fused_ffn_fwd": 0, "fused_ffn_bwd": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(r: int, m: int, f: int, dtype) -> int:
    """The port's copy of the JAX package's gate
    ``gaot_tpu/ops/pallas/fused_ffn.py::supported``: the TPU kernel's row
    tile for R rows of width M and FFN width F, or 0 where the JAX package
    leaves the SwiGLU to XLA's three products (not bf16 or fp32, M or F not
    a multiple of 128, or weights and fp32 dW accumulators above 64 MiB).
    The FFN routes by this rule, and the kernels take every shape it
    accepts, in both dtypes."""
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
    (r, m), f = x.shape, ts[1].shape[0]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"fused_ffn kernels take bf16 or fp32 with equal dtypes, "
                        f"got {[t.dtype for t in ts]}")
    if not supported(max(r, 1), m, f, x.dtype):
        raise ValueError(f"fused_ffn kernels take the shapes the JAX gate takes "
                         f"(M and F multiples of 128, weights within 64 MiB), "
                         f"got M={m}, F={f}")
    if any(t.device != x.device for t in ts):
        raise ValueError("x and the weights must be on the same device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("fused_ffn takes contiguous, 16-byte aligned tensors")


def _scratch(r, m, f, dtype, bwd, device):
    from .build import entry

    fn = entry("fused_ffn", "gaot_fused_ffn_scratch_bytes", [ctypes.c_int] * 5,
               ctypes.c_longlong)
    n = fn(r, m, f, _DTYPES[dtype], int(bwd))
    return torch.empty(max(n, 16), dtype=torch.uint8, device=device)


def _forward_kernel(x, w1, w3, w2):
    _check_kernel_inputs(x, w1, w3, w2)
    from .build import check, entry

    r, m = x.shape
    f = w1.shape[0]
    out = torch.empty_like(x)
    if r == 0:
        return out
    scratch = _scratch(r, m, f, x.dtype, False, x.device)
    fn = entry("fused_ffn", "gaot_fused_ffn_fwd",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), r, m, f, _DTYPES[x.dtype], stream)
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
    kernels (bf16 at M = 128, 256: the rows kernel, the row-split dW
    partials, their fixed-order sum; bf16 at other widths: the producer, dx
    with the dW partials, their sum; fp32: the transposes, the producer, dx
    with the dW partials, their sum)."""
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
    dt = _DTYPES[x.dtype]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = entry("fused_ffn", "gaot_fused_ffn_bwd_splits",
                   [ctypes.c_int] * 5)(r, m, f, dt, sms)
    part = torch.empty((splits, 3 * f * m), dtype=torch.float32, device=x.device)
    scratch = _scratch(r, m, f, x.dtype, True, x.device)
    fn = entry("fused_ffn", "gaot_fused_ffn_bwd",
               [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
            part.data_ptr(), dw.data_ptr(), r, m, f, splits, dt, stream)
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
