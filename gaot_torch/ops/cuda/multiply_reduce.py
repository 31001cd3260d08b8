"""AGNO multiply-reduce and its coefficient gradient.

- :func:`multiply_reduce_k`: out[q, b·C + c] = Σ_k coef[k, q, c] · gath[k, q, b·C + c].
  Replaces ``gaot_tpu/ops/pallas/multiply_reduce.py::multiply_reduce_k``
  (kernel body ``_mulred_k_kernel``), the reduce of the AGNO forward over the
  gathered neighbour rows (once per encoder degree bucket and once for the
  dense decoder graph on the fx main path) and of d_f over the transpose
  graphs (once per in-degree group of the encoder, once for the decoder).
- :func:`multiply_reduce_b`: d_coef[k, q, c] = Σ_b gath[k, q, b·C + c] · dout[q, b·C + c].
  Replaces ``multiply_reduce_b`` (kernel body ``_mulred_b_kernel``), the
  coefficient gradient of each forward call, from the gathered rows the
  forward saved.

Bound on the H100: memory. The kernel reads the gathered [K, Q, W] tensor
once (W = B·C lanes, bf16 or fp32) and does 2 flops per element read, far
below the card's operations-per-byte balance.

Design (``gaot_torch/csrc/multiply_reduce.cu``): each block owns 4 query
rows and a chunk of 64 lane-vectors; each thread streams 16-byte vectors of
``gath`` down the k axis with fp32 accumulators, so every byte of ``gath``
is read exactly once with coalesced 16-byte loads. The block's coef rows
(a few KB) are staged once in shared memory and broadcast to the lanes that
share a channel (``coef[k, q, w mod C]``). Any K, Q, C and b are taken; the
TPU kernel's query folding and 128-lane gate were tiling constraints of the
TPU, not semantics. The output has gath's dtype.

``multiply_reduce_b`` is memory-bound the same way: it reads each gathered
row once and each dout row once per k (from L2: the blocks of one query
range run side by side), for 2 flops per element. Its bytes per query row
are few at narrow lanes (W = 16 on the 3D long path, 64 on the flagship),
so the design follows the lane width, as the TPU kernel's query folding
does for its 128 lanes: a row takes tc·ns threads (tc 16-byte channel
vectors, ns = ceil(b / 8) slices of b), a block holds 256 / (tc·ns)
contiguous query rows of one k, and k is the grid's fastest index, so every
block runs 256 threads and small degree buckets still fill the card. Each
thread sums its slice of b in fp32 registers; with one slice (b ≤ 8) it
writes its outputs straight from registers, otherwise the slices are folded
in a fixed order through shared memory (deterministic, no atomics). The
output has dout's dtype, as the TPU kernel declares.
"""
from __future__ import annotations

import ctypes

import torch

launches = {"multiply_reduce_k": 0, "multiply_reduce_b": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def multiply_reduce_k_plain(coef_km: torch.Tensor, gath_km: torch.Tensor,
                            b: int) -> torch.Tensor:
    """The plain PyTorch version: fp32 products and sums, output in
    gath's dtype. coef_km [K, Q, C], gath_km [K, Q, W = b·C] → [Q, W]."""
    k, q, c = coef_km.shape
    w = gath_km.shape[-1]
    out = torch.einsum("kqc,kqbc->qbc", coef_km.float(),
                       gath_km.float().reshape(k, q, b, c))
    return out.reshape(q, w).to(gath_km.dtype)


def multiply_reduce_k(coef_km: torch.Tensor, gath_km: torch.Tensor,
                      b: int) -> torch.Tensor:
    """out[q, w] = Σ_k coef_km[k, q, w mod C] · gath_km[k, q, w].

    coef_km: [K, Q, C] (any strides over K and Q, C contiguous);
    gath_km: [K, Q, W] contiguous with W = b·C. Returns [Q, W] in
    gath_km's dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    k, q, c = coef_km.shape
    w = gath_km.shape[-1]
    if gath_km.shape[:2] != (k, q) or w != b * c:
        raise ValueError(f"shape mismatch: coef {tuple(coef_km.shape)}, "
                         f"gath {tuple(gath_km.shape)}, b={b}")
    if gath_km.device.type == "cpu":
        return multiply_reduce_k_plain(coef_km, gath_km, b)
    if gath_km.dtype not in _DTYPES or coef_km.dtype != gath_km.dtype:
        raise TypeError(f"multiply_reduce_k takes bf16 or fp32 with equal "
                        f"dtypes, got {coef_km.dtype} and {gath_km.dtype}")
    if coef_km.device != gath_km.device:
        raise ValueError("coef and gath must be on the same device")
    if not gath_km.is_contiguous():
        raise ValueError("gath must be contiguous")
    if c and coef_km.stride(2) != 1:
        raise ValueError("coef's channel axis must be contiguous")
    from .build import check, entry

    out = torch.empty((q, w), dtype=gath_km.dtype, device=gath_km.device)
    if q == 0 or w == 0:
        return out
    fn = entry("multiply_reduce", "gaot_mulred_k",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
               + [ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(gath_km.device).cuda_stream
    rc = fn(gath_km.data_ptr(), coef_km.data_ptr(), out.data_ptr(),
            k, q, c, w, coef_km.stride(0), coef_km.stride(1),
            _DTYPES[gath_km.dtype], stream)
    check(rc, "multiply_reduce_k")
    launches["multiply_reduce_k"] += 1
    return out


def multiply_reduce_b_plain(gath_km: torch.Tensor, dout: torch.Tensor,
                            b: int) -> torch.Tensor:
    """The plain PyTorch version: fp32 products and sums, output in dout's
    dtype. gath_km [K, Q, W = b·C], dout [Q, W] → [K, Q, C]."""
    k, q, w = gath_km.shape
    c = w // b
    out = torch.einsum("kqbc,qbc->kqc", gath_km.float().reshape(k, q, b, c),
                       dout.float().reshape(q, b, c))
    return out.to(dout.dtype)


def multiply_reduce_b(gath_km: torch.Tensor, dout: torch.Tensor,
                      b: int) -> torch.Tensor:
    """d_coef[k, q, c] = Σ_b gath_km[k, q, b·C + c] · dout[q, b·C + c].

    gath_km: [K, Q, W] contiguous; dout: [Q, W] contiguous, W = b·C.
    Returns [K, Q, C] in dout's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    k, q, w = gath_km.shape
    if dout.shape != (q, w) or b <= 0 or w % b:
        raise ValueError(f"shape mismatch: gath {tuple(gath_km.shape)}, "
                         f"dout {tuple(dout.shape)}, b={b}")
    c = w // b
    if gath_km.device.type == "cpu":
        return multiply_reduce_b_plain(gath_km, dout, b)
    if gath_km.dtype not in _DTYPES or dout.dtype != gath_km.dtype:
        raise TypeError(f"multiply_reduce_b takes bf16 or fp32 with equal "
                        f"dtypes, got {gath_km.dtype} and {dout.dtype}")
    if dout.device != gath_km.device:
        raise ValueError("gath and dout must be on the same device")
    if not (gath_km.is_contiguous() and dout.is_contiguous()):
        raise ValueError("gath and dout must be contiguous")
    from .build import check, entry

    out = torch.empty((k, q, c), dtype=dout.dtype, device=dout.device)
    if out.numel() == 0:
        return out
    fn = entry("multiply_reduce", "gaot_mulred_b",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(gath_km.device).cuda_stream
    rc = fn(gath_km.data_ptr(), dout.data_ptr(), out.data_ptr(), k, q, c, w,
            _DTYPES[dout.dtype], stream)
    check(rc, "multiply_reduce_b")
    launches["multiply_reduce_b"] += 1
    return out
