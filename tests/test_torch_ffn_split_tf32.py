"""The split-TF32 arithmetic of the fp32 SwiGLU kernels
(``gaot_torch/csrc/fused_ffn.cu``, ``ffn_tf32_*``), emulated in PyTorch on
the CPU, against the JAX package's ``_ffn_call`` and ``_ffn_bwd_call`` at
fp32, run in interpret mode.

The kernels hold each fp32 operand x as hi = tf32(x) and lo = tf32(x - hi),
with tf32 the round to nearest (ties away from zero) onto 10 mantissa bits
that ``cvt.rna.tf32.f32`` does, and take each product A B as
A_lo B_hi + A_hi B_lo + A_hi B_hi with fp32 sums; the SwiGLU around the
products stays fp32, as ``_fwd_kernel`` and ``_bwd_kernel`` compute it at
``compute_dtype = float32``: z = silu(h1) h3, dh1 = dz h3 silu'(h1),
dh3 = dz silu(h1). The products are the kernels': h1 | h3 = x [W1; W3]^T,
out = z W2^T, dz = dout W2, dx = [dh1 dh3] [W1; W3], dW1 | dW3 =
[dh1 dh3]^T x, dW2 = dout^T z (torch's Linear layouts: W1, W3 [F, M], W2
[M, F]). The emulation holds to the fp32 bounds of the card's checks
(``chip_smoke.py``'s widths phase; ``tests/test_torch_cuda.py``): the
forward rtol 1e-4, atol 1e-5, each gradient 1e-4 of its largest entry; a
single TF32 pass a product does not, which is why the kernels take three.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

RTOL, ATOL = 1e-4, 1e-5      # the forward
GRAD_REL = 1e-4              # each gradient, of its largest entry
R, FF = 200, 256             # ragged R against the kernels' 128-row tiles


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


def _forward(x, w1, w3, w2, passes):
    h1, h3 = _mm(x, w1.t(), passes), _mm(x, w3.t(), passes)
    return _mm(F.silu(h1) * h3, w2.t(), passes)


def _backward(x, w1, w3, w2, dout, passes):
    """(dx, dW1, dW3, dW2) with the kernels' products and fp32 SwiGLU."""
    h1, h3 = _mm(x, w1.t(), passes), _mm(x, w3.t(), passes)
    dz = _mm(dout, w2, passes)
    sg = torch.sigmoid(h1)
    z = h1 * sg * h3
    dh1 = dz * h3 * (sg * (1.0 + h1 * (1.0 - sg)))
    dh3 = dz * h1 * sg
    dx = _mm(torch.cat([dh1, dh3], 1), torch.cat([w1, w3], 0), passes)
    dw13 = _mm(torch.cat([dh1, dh3], 1).t(), x, passes)
    return dx, dw13[:w1.shape[0]], dw13[w1.shape[0]:], _mm(dout.t(), z, passes)


@functools.lru_cache(maxsize=None)
def _case(m):
    """Seeded x, W1, W3, W2 (torch layouts), dout, and gaot_tpu's fp32
    output and (dx, dW1, dW3, dW2) in torch layouts, at R rows, width m."""
    from jax.experimental.pallas import tpu as pltpu  # noqa: F401 (the Pallas TPU backend)

    from gaot_tpu.ops.pallas.fused_ffn import _ffn_bwd_call, _ffn_call

    rng = np.random.default_rng(m)
    x = rng.normal(size=(R, m)).astype(np.float32)
    w1 = (rng.normal(size=(FF, m)) / np.sqrt(m)).astype(np.float32)
    w3 = (rng.normal(size=(FF, m)) / np.sqrt(m)).astype(np.float32)
    w2 = (rng.normal(size=(m, FF)) / np.sqrt(FF)).astype(np.float32)
    dout = rng.normal(size=(R, m)).astype(np.float32)
    # gaot_tpu's layouts: w1, w3 [M, F], w2 [F, M].
    xj, w1j, w3j, w2j, dj = (jnp.asarray(a) for a in (x, w1.T, w3.T, w2.T, dout))
    out = np.asarray(_ffn_call(xj, w1j, w3j, w2j, interpret=True))
    dx, dw1, dw3, dw2 = (np.asarray(a) for a in
                         _ffn_bwd_call(xj, w1j, w3j, w2j, dj, interpret=True))
    return (x, w1, w3, w2, dout), (out, (dx, dw1.T, dw3.T, dw2.T))


def _inputs(m):
    arrays, want = _case(m)
    return [torch.from_numpy(a) for a in arrays], want


def _within(got, want, rel):
    return float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


@pytest.mark.parametrize("m", [128, 256])
def test_split_tf32_forward_matches_pallas(m):
    """The forward, three TF32 passes a product, against ``_ffn_call``."""
    (x, w1, w3, w2, _), (out, _) = _inputs(m)
    got = _forward(x, w1, w3, w2, passes=3)
    np.testing.assert_allclose(got.numpy(), out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", [128, 256])
def test_split_tf32_backward_matches_pallas(m):
    """dx, dW1, dW3, dW2, three TF32 passes a product, against
    ``_ffn_bwd_call``: each within 1e-4 of its largest entry."""
    (x, w1, w3, w2, dout), (_, want) = _inputs(m)
    got = _backward(x, w1, w3, w2, dout, passes=3)
    for name, g, w in zip(("dx", "dw1", "dw3", "dw2"), got, want):
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        assert err <= GRAD_REL, f"{name}: {err:.3e} of its largest entry"


@pytest.mark.parametrize("m", [128, 256])
def test_one_tf32_pass_misses_the_fp32_bound(m):
    """One TF32 pass a product (what TF32 matmuls do) leaves the output
    outside the forward's fp32 tolerances and a gradient outside 1e-4 of
    its largest entry, at the same inputs."""
    (x, w1, w3, w2, dout), (out, want) = _inputs(m)
    got = _forward(x, w1, w3, w2, passes=1)
    assert not np.allclose(got.numpy(), out, rtol=RTOL, atol=ATOL)
    grads = _backward(x, w1, w3, w2, dout, passes=1)
    assert not all(_within(g.numpy(), w, GRAD_REL) for g, w in zip(grads, want))
