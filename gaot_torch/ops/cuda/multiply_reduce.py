"""AGNO multiply-reduce: out[q, b·C + c] = Σ_k coef[k, q, c] · gath[k, q, b·C + c].

Replaces ``gaot_tpu/ops/pallas/multiply_reduce.py::multiply_reduce_k``
(kernel body ``_mulred_k_kernel``), the reduce of the AGNO forward over the
gathered neighbour rows: once per encoder degree bucket and once for the
dense decoder graph on the fx main path.

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
"""
from __future__ import annotations

import ctypes

import torch

KERNEL_NAME = "multiply_reduce_k"
launches = 0

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
    from .build import check, load, refuse_grad

    refuse_grad(coef_km, gath_km)

    global launches
    out = torch.empty((q, w), dtype=gath_km.dtype, device=gath_km.device)
    if q == 0 or w == 0:
        return out
    lib = load("multiply_reduce")
    fn = lib.gaot_mulred_k
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(gath_km.device).cuda_stream
    rc = fn(gath_km.data_ptr(), coef_km.data_ptr(), out.data_ptr(),
            k, q, c, w, coef_km.stride(0), coef_km.stride(1),
            _DTYPES[gath_km.dtype], stream)
    check(rc, "multiply_reduce_k")
    launches += 1
    return out
