"""The split-TF32 arithmetic of the fp32 flash kernels above head dim 128
(``gaot_torch/csrc/flash_wide_f32.cu``), emulated in PyTorch on the CPU,
against the JAX package's ``_flash_forward(with_lse=True)`` and
``_flash_backward`` run in interpret mode.

The kernels hold each fp32 operand x as hi = tf32(x) and lo = tf32(x - hi),
with tf32 the round to nearest (ties away from zero) onto 10 mantissa bits
that ``cvt.rna.tf32.f32`` does, and take each product A B as
A_lo B_hi + A_hi B_lo + A_hi B_hi with fp32 sums; around the products the
arithmetic is theirs: fp32 scores, exp2 against the row max, the base-2
LSE, p from the LSE in the backward and the scale applied at the end of dQ
and dK. The emulation holds to the module's fp32 tolerances (rtol 1e-4,
atol 1e-5; the LSE 1e-5, as in tests/test_torch_kernels_bwd.py), and a
single TF32 pass a product does not: that is why the kernels take three.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

RTOL, ATOL = 1e-4, 1e-5
LOG2E = 1.4426950408889634
B, S, H, HKV = 1, 128, 4, 2


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to the nearest tf32 (10 mantissa bits), ties away from
    zero: add half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels' tensor cores take it: three TF32 products of
    the split operands, or (passes = 1) one of the rounded operands."""
    if passes == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _heads(x, group=1):
    """[B, S, n, D] -> [B, n * group, S, D], each kv-head repeated for its
    group of q-heads (the kernels read it by index)."""
    return x.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)


def _forward(q, k, v, passes):
    """(out [B, S, H, D], lse [B, H, S]) with the kernels' arithmetic."""
    d = q.shape[-1]
    c = LOG2E / math.sqrt(d)
    qh, kh, vh = _heads(q), _heads(k, H // HKV), _heads(v, H // HKV)
    s = _mm(qh, kh.transpose(-1, -2), passes)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s * c - m * c)
    den = p.sum(-1, keepdim=True)
    out = _mm(p, vh, passes) / den
    return out.permute(0, 2, 1, 3), (m * c + torch.log2(den))[..., 0]


def _backward(q, k, v, o, do, lse, passes):
    """(dq, dk, dv) with the kernels' arithmetic: p from the LSE,
    delta = rowsum(dO O), dS = p (dP - delta), the GQA partials of dK and
    dV summed in fp32 over the group."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    g = H // HKV
    qh, kh, vh = _heads(q), _heads(k, g), _heads(v, g)
    oh, doh = _heads(o), _heads(do)
    p = torch.exp2(_mm(qh, kh.transpose(-1, -2), passes) * (scale * LOG2E) - lse[..., None])
    dp = _mm(doh, vh.transpose(-1, -2), passes)
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True))
    dq = _mm(ds, kh, passes) * scale
    fold = lambda x: x.reshape(B, HKV, g, S, d).sum(2).permute(0, 2, 1, 3)
    dk = fold(_mm(ds.transpose(-1, -2), qh, passes) * scale)
    dv = fold(_mm(p.transpose(-1, -2), doh, passes))
    return dq.permute(0, 2, 1, 3), dk, dv


def _hm(x):
    return jnp.transpose(x, (0, 2, 1, 3))


@functools.lru_cache(maxsize=None)
def _case(d):
    """Seeded q, k, v, dO [B, S, heads, D] and gaot_tpu's out, LSE, dq, dk,
    dv at head dim d (token-major numpy)."""
    from gaot_tpu.ops.pallas.flash_attention import _flash_backward, _flash_forward

    rng = np.random.default_rng(d)
    q, k, v, do = (rng.normal(size=(B, S, n, d)).astype(np.float32)
                   for n in (H, HKV, HKV, H))
    qj, kj, vj, doj = (_hm(jnp.asarray(a)) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_forward(qj, kj, vj, 128, with_lse=True)
        grads = _flash_backward(qj, kj, vj, out, doj)
    tok = lambda x: np.array(_hm(x))
    return (q, k, v, do), (tok(out), np.array(lse).reshape(B, H, S),
                           *(tok(x) for x in grads))


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("d", [256, 1024])
def test_split_tf32_forward_matches_pallas(d):
    """The forward's output and base-2 LSE, three TF32 passes a product,
    against ``_flash_forward(with_lse=True)``."""
    (q, k, v, _), (out, lse, *_) = _case(d)
    got_out, got_lse = _forward(*_torch(q, k, v), passes=3)
    np.testing.assert_allclose(got_out.numpy(), out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [256, 1024])
def test_split_tf32_backward_matches_pallas(d):
    """dQ, dK, dV, three TF32 passes a product, from JAX's output and the
    emulated forward's LSE, against ``_flash_backward`` (S = 128: its
    monolithic kernel), GQA 4:2."""
    (q, k, v, do), (out, _, *want) = _case(d)
    qt, kt, vt, dot, ot = _torch(q, k, v, do, out)
    _, lse = _forward(qt, kt, vt, passes=3)
    got = _backward(qt, kt, vt, ot, dot, lse, passes=3)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [256, 1024])
def test_one_tf32_pass_misses_the_fp32_bound(d):
    """One TF32 pass a product (what TF32 matmuls do) leaves the output and
    dQ outside the fp32 tolerances at the same inputs."""
    (q, k, v, do), (out, _, dq, *_) = _case(d)
    qt, kt, vt, dot, ot = _torch(q, k, v, do, out)
    got_out, lse = _forward(qt, kt, vt, passes=1)
    assert not np.allclose(got_out.numpy(), out, rtol=RTOL, atol=ATOL)
    got_dq = _backward(qt, kt, vt, ot, dot, lse, passes=1)[0]
    assert not np.allclose(got_dq.numpy(), dq, rtol=RTOL, atol=ATOL)
