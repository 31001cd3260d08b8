"""Grouped-query attention softmax(Q·Kᵀ/√D)·V, forward and backward.

Replaces ``gaot_tpu/ops/pallas/flash_attention.py::_flash_forward``
(kernel bodies ``_attn_kernel`` and, with the LSE output, ``_attn_kernel_lse``)
and all three regimes of the TPU backward: ``_flash_backward`` at S ≤ 1024
(``_attn_bwd_kernel``) and at 1024 < S ≤ 4096 (``_attn_bwd_tiled_kernel``),
both with the math of ``_bwd_core``, and ``_flash_backward_long`` for
S > 4096 (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``). Forward and backward run
once per UViT layer: on the fx main path at (B=64, H=Hkv=8, S=1024, D=32),
on the 3D flagship at (B=4, H=Hkv=8, S=4096, D=24), and at patch 2 at
S=32768.

Bound on the H100: at D=32 the products do 4·B·H·S²·D operations forward and
10·B·H·S²·D backward against 2·S·D bytes of K/V per query tile, so the
tensor cores and the exp2 (one per score, each way) bound them, not memory:
the [S, S] scores never leave the chip.

Forward design (``gaot_torch/csrc/flash_attention.cu``), bf16: one block per
(batch·q-head, 128 queries), two warpgroups of 64 query rows. The block
indexes its kv-head as head // (H / Hkv), so GQA needs no copy of K/V. K and
V stream through a ring of three shared-memory stages of 64 keys filled by
16-byte ``cp.async``, so the next tile's copy overlaps this tile's work, in
the no-swizzle core-matrix layout of ``wgmma``: K is the K-major B operand
of S = Q·Kᵀ and V, in its natural [key, D] layout, the transposed B operand
of P·V (no element-wise transpose). Both products run on the tensor cores
through ``wgmma`` with A in registers (Q, then P from the S accumulator,
whose layout is P·V's A fragment); S_j is issued together with the previous
tile's P·V, whose product runs while the softmax of S_j does. Online
softmax: fp32 running max and per-thread partial denominators, one FFMA and
one ``ex2.approx`` per score (exp2(s·c − m·c), c = scale·log2 e), only the
ragged last tile masked, P rounded to V's dtype before P·V (as the TPU
kernel does), the output divided by the fp32 denominator once at the end.
For training it also writes the base-2 row LSE m + log2(l), as
``_attn_kernel_lse`` defines it. What bounds it is the exp2 of the
special-function units; the tensor cores come second. fp32 (the dtype
every example config trains in) stays in fp32 FFMA on the CUDA cores, no
TF32, so the card's fp32 rate bounds it: Q is staged once in shared
memory, K and V stream through a two-stage ``cp.async`` ring, and each
warp builds S and then O += P·V as register micro-tiles (8 queries × 8
keys a lane at D ≤ 32) from 16-byte shared-memory loads, the same online
softmax per row over the lanes that hold it, P through a shared tile of
the warp's own (``csrc/flash_f32.cuh`` holds the tile table by D). The
TPU kernel keeps all of K/V resident instead; in fp32 that is 256 KB per
head at S=1024, above a block's 227 KB of shared memory, and 3D grids
reach S = 32k. Any S is taken (the ragged last tile is
masked). D may be any multiple of 8 (``supports_head_dim``), as the JAX
gates take it: the kernels above are templates built for every D from 8 to
128 (``TEMPLATED_HEAD_DIMS``; at D % 16 == 8 the products over D pad the
last k-step of 16 with zeros); above 128 a route with D at run time takes
over, forward and backward, with the arithmetic of the templated kernels.
In bf16 (``gaot_torch/csrc/flash_wide.cu``) every product runs on
``wgmma``: a block of two warpgroups owns 128 rows and one slice of its
outputs' head dim (a grid dimension; 256 columns in the forward and dQ,
128 in dK/dV) and recomputes the full-D scores, and dP, for it, the
operands streaming through a ``cp.async`` ring in 64-column chunks of the
head dim in the no-swizzle core-matrix layout (K-major over D, MN-major
through the transpose bit where N is D), the resident side kept in shared
memory while it fits (the forward's queries up to D = 512, the backward's
up to 256); the backward is two launches, dQ with δ, then dK/dV. In fp32
(``gaot_torch/csrc/flash_wide_f32.cu``) every product runs on the tensor
cores as split TF32: each operand x is held as hi = tf32(x) and
lo = tf32(x − hi), and each product as three ``wgmma``s (lo·hi, hi·lo,
hi·hi) with fp32 accumulators, which keeps the results to fp32's own
rounding with TF32 left off. A tf32 ``wgmma`` reads both shared-memory
operands K-major, so the operands whose product has N = D (V, K, dO, Q) are
written transposed by the threads that split them; slices of 256 columns
in the forward and dQ, 128 in dK/dV, everything streamed through a
three-stage ``cp.async`` ring; two launches a backward (PERF.md has both
routes' times).

Backward design (``gaot_torch/csrc/flash_attention_bwd.cu``): the TPU kernel
holds a head's whole [S, S] row block in VMEM; on the card the tiled flash
backward, which the JAX package itself runs for long S (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``), normalises each tile from the saved LSE. Two kernels,
deterministic with no float atomics: a dQ kernel (one block per batch·q-head
and 128 queries, looping over the key tiles), which also computes
δ = rowsum(dO∘O) in fp32 for its rows, then a dK/dV kernel (one block per
batch·kv-head and 128 keys, looping over the group's q-heads and every query
tile, so the GQA group sum stays in fp32 registers). In bf16 every product
runs on ``wgmma``: two warpgroups a block own 64 rows each of the resident
side (Q and dO, or K and V), and two blocks share an SM up to D = 32; the
other side streams through a ``cp.async`` ring (two stages of four 64-row
sub-tiles up to D = 32) whose next copies run under this stage's products;
every tile sits in ``wgmma``'s swizzled layout (the head dim padded to 16,
32, 64 or 128), read K-major by the products over D (S = Q·Kᵀ, dP = dO·Vᵀ
and their transposes) and, through the descriptor's transpose bit,
MN-major by the products whose N is D (dQ += dS·K, dV += Pᵀ·dO,
dK += dSᵀ·Q), whose A operands P and dS come from the accumulators as
register fragments: no operand is transposed element by element. P and dS
are rounded to V's and Q's dtype before their products, as ``_bwd_core``
does. Its arithmetic is ``_flash_backward_long``'s (p from the LSE, the
scale applied at the end of dQ and dK); the plain backward keeps
``_bwd_core``'s. In bf16 the two stay within half of the CPU tests' bound
(rtol 8e-3, atol 1e-2) at S = 384, so one plain backward serves every
regime. fp32 runs the same two kernels' arithmetic in fp32 FFMA on the
CUDA cores, S, dP and the products whose N is D as register micro-tiles,
δ folded into the dQ kernel; with S and dP in both kernels they do 7 of
the products the bound counts as 5, so at most 71% of it.
"""
from __future__ import annotations

import ctypes
import math

import torch

# The forward with the LSE output (training) counts apart from the one
# without (evaluation): they replace two TPU kernels.
launches = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 0,
            "flash_attention_bwd": 0}

# The head dims of the templated kernels; every other multiple of 8 (above
# 128) takes the route with D at run time.
TEMPLATED_HEAD_DIMS = tuple(range(8, 129, 8))
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    with_lse: bool = False):
    """The plain PyTorch version, with the kernel's arithmetic: fp32
    logits, exp2 against the row max, unnormalised P cast to V's dtype,
    fp32 P·V, one division by the fp32 denominator at the end.

    q: [B, S, H, D]; k, v: [B, S, Hkv, D]. Returns [B, S, H, D], and with
    ``with_lse`` also the fp32 base-2 row LSE [B, H, S]."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, s, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (scale * _LOG2E)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    den = p.sum(dim=-1)                                     # [B, Hkv, G, S]
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = (acc / den.permute(0, 3, 1, 2)[..., None]).reshape(b, s, h, d).to(v.dtype)
    if not with_lse:
        return out
    return out, (m[..., 0] + torch.log2(den)).reshape(b, h, s)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor):
    """The plain backward, with the arithmetic of the TPU kernel's
    ``_bwd_core``: recomputed row softmax (unnormalised p̂ against the row
    max), every per-row scale folded into the [*, D] operands
    (dO/den and scale·dO/den cast to V's dtype, δ′ = scale·rowsum(dO∘O)/den),
    dS = p̂∘(dP′ − δ′) cast to Q's dtype, per-q-head dK/dV partials stored
    in Q's dtype and summed over the GQA group.

    Shapes as :func:`attention_plain`; do like q. Returns (dq, dk, dv) in
    q's, k's and v's dtypes."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    vt = v.dtype
    heads = lambda x: x.float().reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    qh, do32, o32 = heads(q), heads(do.to(q.dtype)), heads(o)   # [B,Hkv,G,S,D]
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bhgqd,bkhd->bhgqk", qh, kf) * (scale * _LOG2E)
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    pb = p.to(vt).float()
    inv = 1.0 / p.sum(dim=-1, keepdim=True)                     # [B,Hkv,G,S,1]
    delta = (do32 * o32).sum(-1, keepdim=True) * (inv * scale)
    do_n = (do32 * inv).to(vt).float()
    dv_part = torch.einsum("bhgqk,bhgqd->bhgkd", pb, do_n)
    do_s = (do32 * (inv * scale)).to(vt).float()
    dp = torch.einsum("bhgqd,bkhd->bhgqk", do_s, vf)
    dsb = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", dsb, kf).reshape(b, s, h, d)
    dk_part = torch.einsum("bhgqk,bhgqd->bhgkd", dsb, qh)
    fold = lambda x: x.to(q.dtype).float().sum(2).permute(0, 2, 1, 3)
    return (dq.to(q.dtype), fold(dk_part).to(k.dtype).contiguous(),
            fold(dv_part).to(vt).contiguous())


def supports_head_dim(d: int) -> bool:
    """The head dims the kernels take: every multiple of 8, with no upper
    cap. At S = 128 this is the JAX package's ``_supported`` and
    ``_bwd_supported`` (S % 128 == 0, D % 8 == 0, S·D ≤ 2²⁰) for every D up
    to 8192; the kernels take any S."""
    return d >= 8 and d % 8 == 0


def _check(q, k, v):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _check_kernel_inputs(q, k, v):
    d = q.shape[-1]
    if not supports_head_dim(d):
        raise ValueError(f"flash_attention kernels take a head dim that is a "
                         f"multiple of 8, got {d}")
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


def _entries(q):
    """(library, entry) of the forward and of the backward for q's head dim
    and dtype: the templated kernels up to D = 128, above it the route with
    D at run time, ``csrc/flash_wide.cu`` in bf16 and
    ``csrc/flash_wide_f32.cu`` in fp32."""
    if q.shape[-1] <= TEMPLATED_HEAD_DIMS[-1]:
        return (("flash_attention", "gaot_flash_fwd"),
                ("flash_attention_bwd", "gaot_flash_bwd"))
    lib = "flash_wide" if q.dtype == torch.bfloat16 else "flash_wide_f32"
    return (lib, f"gaot_{lib}_fwd"), (lib, f"gaot_{lib}_bwd")


def _strides(*ts):
    return [st for t in ts for st in (t.stride(0), t.stride(1), t.stride(2))]


def _forward_kernel(q, k, v, with_lse: bool):
    _check_kernel_inputs(q, k, v)
    from .build import check, entry

    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * s * h == 0:
        return out, lse
    lib, sym = _entries(q)[0]
    fn = entry(lib, sym,
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale_log2 = (1.0 / math.sqrt(d)) * _LOG2E
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, h, k.shape[2], d,
            *_strides(q, k, v), scale_log2, _DTYPES[q.dtype], stream)
    check(rc, "flash_attention")
    launches["flash_attention_fwd_lse" if with_lse else "flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor = None):
    """(dq, dk, dv) of GQA attention, contiguous, in q's, k's and v's
    dtypes. o is the forward's output and lse its base-2 row LSE
    [B, H, S] (needed on the card only). CPU tensors take the plain
    version; CUDA tensors launch the backward kernels."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, do)
    _check_kernel_inputs(q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if lse is None or lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError("the backward kernel needs the forward's fp32 LSE [B, H, S]")
    from .build import check, entry

    o = o.to(q.dtype).contiguous()
    do = do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if b * s * h == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib, sym = _entries(q)[1]
    fn = entry(lib, sym,
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
               + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, d, *_strides(q, k, v),
            scale * _LOG2E, scale, _DTYPES[q.dtype], stream)
    check(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the backward kernel (the plain backward
    on CPU tensors). Saves q, k, v, the output and the LSE (which only the
    kernel reads)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, dout, lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """GQA attention. q: [B, S, H, D]; k, v: [B, S, Hkv, D] (any strides
    over B, S and heads, D contiguous). Returns a contiguous [B, S, H, D].
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Where a gradient is needed the call is differentiable through
    :func:`flash_attention_bwd`, and the forward also keeps the LSE."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _forward_kernel(q, k, v, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out, base-2 row LSE [B, H, S]) of the forward, as training keeps
    them. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, with_lse=True)
    return _forward_kernel(q, k, v, with_lse=True)
