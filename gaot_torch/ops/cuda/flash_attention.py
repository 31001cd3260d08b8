"""Grouped-query attention forward: softmax(Q·Kᵀ/√D)·V.

Replaces ``gaot_tpu/ops/pallas/flash_attention.py::_flash_forward``
(kernel body ``_attn_kernel``) for the UViT processor: once per layer on
the fx main path (B=64, H=Hkv=8, S=1024, D=32).

Bound on the H100: at D=32 the two products do 4·B·H·S²·D operations
against 2·S·D bytes of K/V per query tile, so the tensor cores and the
softmax's exp2 (one per score) bound it, not memory: the [S, S] scores never
leave the chip.

Design (``gaot_torch/csrc/flash_attention.cu``): one block per
(batch·q-head, 64-query tile), four warps of 16 query rows. The block
indexes its kv-head as head // (H / Hkv), so GQA needs no copy of K/V. It
streams K/V through shared memory in tiles of 64 keys with an online
softmax: fp32 running max and denominator, exp2 with the logit scale folded
with log2(e), P cast to V's dtype before the P·V product (as the TPU kernel
does), and the output normalised once at the end. bf16 runs on the tensor
cores (``mma.sync`` m16n8k16, fp32 accumulation); fp32 runs the same
algorithm on the CUDA cores. The TPU kernel keeps all of K/V resident
instead; in fp32 that is 256 KB per head at S=1024, above a block's
227 KB of shared memory, and 3D grids reach S = 32k. Any S is taken (the
ragged last tile is masked); D must be 32, the head dim it is built for.
"""
from __future__ import annotations

import ctypes
import math

import torch

KERNEL_NAME = "flash_attention_fwd"
launches = 0

HEAD_DIM = 32
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, with the kernel's arithmetic: fp32
    logits, exp2 against the row max, unnormalised P cast to V's dtype,
    fp32 P·V, one division by the fp32 denominator at the end.

    q: [B, S, H, D]; k, v: [B, S, Hkv, D]. Returns [B, S, H, D]."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, s, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (scale * _LOG2E)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits)
    den = p.sum(dim=-1)                                     # [B, Hkv, G, S]
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = acc / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, d).to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """GQA attention. q: [B, S, H, D]; k, v: [B, S, Hkv, D] (any strides
    over B, S and heads, D contiguous). Returns a contiguous [B, S, H, D].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention kernel is built for head dim "
                         f"{HEAD_DIM}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 with equal "
                        f"dtypes, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on the same device")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(t.stride(i) % vec for i in range(3))):
            raise ValueError("flash_attention takes a contiguous head dim, "
                             "16-byte aligned rows and strides")
    from .build import check, load, refuse_grad

    refuse_grad(q, k, v)

    global launches
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b * s * h == 0:
        return out
    lib = load("flash_attention")
    fn = lib.gaot_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale_log2 = (1.0 / math.sqrt(d)) * _LOG2E
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, hkv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            scale_log2, _DTYPES[q.dtype], stream)
    check(rc, "flash_attention")
    launches += 1
    return out
