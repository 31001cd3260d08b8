"""AGNO multiply-reduce and its coefficient gradient, reading the neighbour
rows by index.

- :func:`gather_multiply_reduce_k`:
  out[row_map[q], b·C + c] = Σ_{k : mask[q, k]} coef(q, k)[c] · src[idx[q, k], b·C + c],
  the coefficient given per edge (``coef[q, k]``, the forward's [Q, K, C])
  or gathered by a second index (``coef[coef_idx[q, k]]``, d_f's
  ``coef_flat[edge_pos]``). Replaces ``gaot_tpu/ops/pallas/multiply_reduce.py
  ::multiply_reduce_k`` (kernel body ``_mulred_k_kernel``) together with the
  row gathers that fed it: the AGNO forward (once per encoder degree bucket
  and once for the dense decoder graph on the fx main path) and d_f over
  the transpose graphs (once per in-degree group, once per flat graph).
- :func:`gather_multiply_reduce_b`:
  d_coef[q, k, c] = Σ_b src[idx[q, k], b·C + c] · dout[q, b·C + c], in the
  coefficient's own [Q, K, C] layout. Replaces ``multiply_reduce_b``
  (kernel body ``_mulred_b_kernel``), the coefficient gradient of each
  forward call, from the same rows the forward read.
- :func:`multiply_reduce_k` and :func:`multiply_reduce_b` keep the TPU
  kernels' own contract, a pre-gathered ``gath [K, Q, W]``: the index-free
  instance of the same two kernels (row k·Q + q of ``gath``).

Bound on the H100: memory. 2 flops per element of a row read, far below
the card's operations-per-byte balance; on the 3D paths a row is 32-128
bytes, so the number of row loads in flight sets the time.

Design (``gaot_torch/csrc/multiply_reduce.cu``): blocks are shaped by the
lane width W = b·C: a row takes one thread per 16-byte vector (2 at W = 16
bf16, 8 at W = 64), a block holds 256 threads' worth of rows; past 256
vectors (the fx path's W = 4096) a block is one row times a chunk of 256
vectors. The forward / d_f kernel keeps a thread at 32 registers, so an SM
holds 2048 threads with their loads in flight: a thread reads its row's
valid slots from the mask 32 at a time, as bits, then one slot at a time
its indices, its row and its coefficient, and sums in fp32 registers in k
order. A masked slot issues no load and no product, so padding costs a bit
and a row with no valid slot writes zeros. Where a row has 16 slots or
more and a power-of-two count of threads below a warp, its slots are split
into slices (k mod ks) over more threads, whose partial sums fold in a
fixed order by warp shuffles (the flagship encoder's transpose graph,
K = 160: 4 slices at W = 64, 16 at W = 16). Coefficients and indices are
streamed with the evict-first hint, so the source rows stay in L2.
``multiply_reduce_b`` keeps its lane-width design: a row takes
tc·ns threads (tc 16-byte channel vectors, ns = ceil(b / 8) slices of b),
a block holds 256 / (tc·ns) contiguous query rows of one k, k is the
grid's fastest index; each thread reads its row's index once and sums its
slice of b in fp32 registers; with one slice (b ≤ 8) it writes its outputs
straight from registers, otherwise the slices are folded in a fixed order
through shared memory. Both are deterministic: no atomics, a fixed
summation order. Any K, Q, C and b are taken; indices are int64 (as
``graph_to_device`` gives them) or int32. Outputs have the source rows'
dtype.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

launches = {"multiply_reduce_k": 0, "multiply_reduce_b": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_BITS = {torch.int64: 64, torch.int32: 32}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(what: str, src: torch.Tensor, *tensors) -> None:
    """The rules of both kernels: bf16 or fp32 rows, the rows and every
    other tensor given on the rows' device and contiguous."""
    if src.dtype not in _DTYPES:
        raise TypeError(f"{what} takes bf16 or fp32 rows, got {src.dtype}")
    for t in (src, *tensors):
        if t is None:
            continue
        if t.device != src.device:
            raise ValueError(f"{what}: every tensor must be on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: every index, mask and row tensor must be contiguous")


def _index_bits(what: str, *indices) -> int:
    """The common width of the index tensors given (64 when none is)."""
    dtypes = {t.dtype for t in indices if t is not None}
    if not dtypes:
        return 64
    if len(dtypes) > 1 or not dtypes <= set(_INDEX_BITS):
        raise TypeError(f"{what}: indices must all be int64 or all int32, got {dtypes}")
    return _INDEX_BITS[dtypes.pop()]


def gather_multiply_reduce_k_plain(src: torch.Tensor, idx: torch.Tensor,
                                   coef: torch.Tensor, b: int,
                                   coef_idx: Optional[torch.Tensor] = None,
                                   mask: Optional[torch.Tensor] = None,
                                   row_map: Optional[torch.Tensor] = None,
                                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`gather_multiply_reduce_k`:
    ``index_select`` of the rows and coefficients, masked slots zeroed, an
    fp32 ``einsum``; the result in src's dtype."""
    q, k = idx.shape
    w = src.shape[1]
    c = w // b
    if mask is not None:
        idx = torch.where(mask, idx, 0)
    rows = src.index_select(0, idx.reshape(-1)).view(q, k, b, c).float()
    if coef_idx is None:
        cf = coef.float()
    else:
        if mask is not None:
            coef_idx = torch.where(mask, coef_idx, 0)
        cf = coef.index_select(0, coef_idx.reshape(-1)).view(q, k, c).float()
    if mask is not None:
        cf = torch.where(mask[..., None], cf, 0)
        rows = torch.where(mask[..., None, None], rows, 0)
    res = torch.einsum("qkc,qkbc->qbc", cf, rows).reshape(q, w).to(src.dtype)
    if out is None:
        return res
    if row_map is None:
        return out.copy_(res)
    return out.index_copy_(0, row_map.long(), res)


def gather_multiply_reduce_k(src: torch.Tensor, idx: torch.Tensor,
                             coef: torch.Tensor, b: int, *,
                             coef_idx: Optional[torch.Tensor] = None,
                             mask: Optional[torch.Tensor] = None,
                             row_map: Optional[torch.Tensor] = None,
                             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[row_map[q], b·C + c] = Σ_{k : mask[q, k]} coef(q, k)[c] · src[idx[q, k], b·C + c].

    src: [N, W] rows, W = b·C; idx: [Q, K] int64 or int32; coef: per edge
    [Q, K, C] (C contiguous, any strides over Q and K) when ``coef_idx`` is
    None, else a [E, C] table read at rows ``coef_idx`` [Q, K]; mask: bool
    [Q, K] (None: every slot), a masked slot's indices are never read;
    row_map: [Q] output row of each query row (needs ``out``); out: [R, W]
    to write into (None: a new [Q, W]). Returns the output, in src's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    q, k = idx.shape
    _, w = src.shape
    if b <= 0 or w % b:
        raise ValueError(f"shape mismatch: src {tuple(src.shape)}, b={b}")
    c = w // b
    want_coef = (q, k, c) if coef_idx is None else (coef.shape[0], c)
    if (tuple(coef.shape) != want_coef
            or (coef_idx is not None and coef_idx.shape != (q, k))
            or (mask is not None and mask.shape != (q, k))
            or (row_map is not None and (row_map.shape != (q,) or out is None))
            or (out is not None and (out.shape[1:] != (w,)
                                     or (row_map is None and out.shape[0] != q)))):
        raise ValueError(f"shape mismatch: src {tuple(src.shape)}, idx {tuple(idx.shape)}, "
                         f"coef {tuple(coef.shape)}, b={b}")
    if src.device.type == "cpu":
        return gather_multiply_reduce_k_plain(src, idx, coef, b, coef_idx, mask,
                                              row_map, out)
    _check_cuda("gather_multiply_reduce_k", src, idx, coef_idx, mask, row_map, out)
    if coef.dtype != src.dtype or (out is not None and out.dtype != src.dtype):
        raise TypeError(f"gather_multiply_reduce_k: coef {coef.dtype} and out must "
                        f"have the rows' dtype {src.dtype}")
    if coef.device != src.device:
        raise ValueError("gather_multiply_reduce_k: coef must be on the rows' device")
    if coef_idx is None:
        if c and coef.stride(2) != 1:
            raise ValueError("coef's channel axis must be contiguous")
        cs_q, cs_k = coef.stride(0), coef.stride(1)
    else:
        if not coef.is_contiguous():
            raise ValueError("a coefficient table must be contiguous")
        cs_q = cs_k = 0
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    bits = _index_bits("gather_multiply_reduce_k", idx, coef_idx, row_map)
    if out is None:
        out = torch.empty((q, w), dtype=src.dtype, device=src.device)
    _launch_k(src, idx, coef, coef_idx, mask, row_map, out, k, q, c, w, cs_q, cs_k,
              bits)
    return out


def _launch_k(src, idx, coef, coef_idx, mask, row_map, out, k, q, c, w, cs_q, cs_k,
              bits):
    if q == 0 or w == 0:
        return
    from .build import check, entry

    fn = entry("multiply_reduce", "gaot_mulred_k",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = fn(src.data_ptr(), _ptr(idx), coef.data_ptr(), _ptr(coef_idx), _ptr(mask),
            _ptr(row_map), out.data_ptr(), k, q, c, w, cs_q, cs_k, bits,
            _DTYPES[src.dtype], stream)
    check(rc, "multiply_reduce_k")
    launches["multiply_reduce_k"] += 1


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
    """out[q, w] = Σ_k coef_km[k, q, w mod C] · gath_km[k, q, w]: the TPU
    kernel's contract, the index-free instance of
    :func:`gather_multiply_reduce_k` (row k·Q + q of gath).

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
    _check_cuda("multiply_reduce_k", gath_km)
    if coef_km.dtype != gath_km.dtype:
        raise TypeError(f"multiply_reduce_k takes bf16 or fp32 with equal "
                        f"dtypes, got {coef_km.dtype} and {gath_km.dtype}")
    if coef_km.device != gath_km.device:
        raise ValueError("coef and gath must be on the same device")
    if c and coef_km.stride(2) != 1:
        raise ValueError("coef's channel axis must be contiguous")
    out = torch.empty((q, w), dtype=gath_km.dtype, device=gath_km.device)
    _launch_k(gath_km, None, coef_km, None, None, None, out, k, q, c, w,
              coef_km.stride(1), coef_km.stride(0), 64)
    return out


def gather_multiply_reduce_b_plain(src: torch.Tensor, idx: torch.Tensor,
                                   dout: torch.Tensor, b: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`gather_multiply_reduce_b`:
    ``index_select`` of the rows, an fp32 ``einsum``; the result in dout's
    dtype."""
    q, k = idx.shape
    c = src.shape[1] // b
    rows = src.index_select(0, idx.reshape(-1)).view(q, k, b, c).float()
    out = torch.einsum("qkbc,qbc->qkc", rows, dout.float().view(q, b, c))
    return out.to(dout.dtype)


def gather_multiply_reduce_b(src: torch.Tensor, idx: torch.Tensor,
                             dout: torch.Tensor, b: int) -> torch.Tensor:
    """d_coef[q, k, c] = Σ_b src[idx[q, k], b·C + c] · dout[q, b·C + c].

    src: [N, W] rows, W = b·C; idx: [Q, K] int64 or int32; dout: [Q, W].
    Returns [Q, K, C] in dout's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    q, k = idx.shape
    w = src.shape[1]
    if dout.shape != (q, w) or b <= 0 or w % b:
        raise ValueError(f"shape mismatch: src {tuple(src.shape)}, idx "
                         f"{tuple(idx.shape)}, dout {tuple(dout.shape)}, b={b}")
    c = w // b
    if src.device.type == "cpu":
        return gather_multiply_reduce_b_plain(src, idx, dout, b)
    _check_cuda("gather_multiply_reduce_b", src, idx, dout)
    if dout.dtype != src.dtype:
        raise TypeError(f"gather_multiply_reduce_b takes equal dtypes, got "
                        f"{src.dtype} and {dout.dtype}")
    bits = _index_bits("gather_multiply_reduce_b", idx)
    out = torch.empty((q, k, c), dtype=dout.dtype, device=dout.device)
    _launch_b(src, idx, dout, out, k, q, c, w, k * c, c, bits)
    return out


def _launch_b(src, idx, dout, out, k, q, c, w, os_q, os_k, bits):
    if out.numel() == 0:
        return
    from .build import check, entry

    fn = entry("multiply_reduce", "gaot_mulred_b",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = fn(src.data_ptr(), _ptr(idx), dout.data_ptr(), out.data_ptr(), k, q, c, w,
            os_q, os_k, bits, _DTYPES[dout.dtype], stream)
    check(rc, "multiply_reduce_b")
    launches["multiply_reduce_b"] += 1


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
    """d_coef[k, q, c] = Σ_b gath_km[k, q, b·C + c] · dout[q, b·C + c]: the
    TPU kernel's contract, the index-free instance of
    :func:`gather_multiply_reduce_b` (row k·Q + q of gath).

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
    _check_cuda("multiply_reduce_b", gath_km, dout)
    if dout.dtype != gath_km.dtype:
        raise TypeError(f"multiply_reduce_b takes bf16 or fp32 with equal "
                        f"dtypes, got {gath_km.dtype} and {dout.dtype}")
    out = torch.empty((k, q, c), dtype=dout.dtype, device=dout.device)
    _launch_b(gath_km, None, dout, out, k, q, c, w, c, q * c, 64)
    return out
