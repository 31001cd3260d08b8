"""The plain PyTorch versions of the port's three kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own kernel tests run them; CPU tensors take the plain route and
leave the launch counters at 0.

Tolerances: fp32 rtol/atol 1e-5 (same fp32 arithmetic, other summation
order); bf16 compares the bf16 outputs of fp32 accumulations, so one bf16
ulp of the output (rtol 8e-3) plus atol 1e-2 for values near zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gaot_torch.ops import cuda as kernels
from gaot_torch.ops.cuda import flash_attention as fa
from gaot_torch.ops.cuda import fused_ffn as ff
from gaot_torch.ops.cuda import multiply_reduce as mr

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 8e-3, 1e-2)}


def _both(a, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.fixture(autouse=True)
def _zero_counters():
    kernels.reset_launches()
    yield
    assert kernels.launch_counts() == {
        "multiply_reduce_k": 0, "flash_attention_fwd": 0, "fused_ffn_fwd": 0}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,q,b,c", [(5, 24, 4, 64), (12, 16, 2, 64)])
def test_multiply_reduce_k_plain_matches_pallas(dtype, k, q, b, c):
    from gaot_tpu.ops.pallas.multiply_reduce import multiply_reduce_k, supported

    jdt, tdt, rtol, atol = DTYPES[dtype]
    assert supported(q, b, c, 2)
    rng = np.random.default_rng(k)
    coef = rng.normal(size=(q, k, c)).astype(np.float32)     # Q-major, as AGNO
    gath = rng.normal(size=(k, q, b * c)).astype(np.float32)
    cj, ct = _both(coef, jdt, tdt)
    gj, gt = _both(gath, jdt, tdt)
    with pltpu.force_tpu_interpret_mode():
        want = multiply_reduce_k(jnp.swapaxes(cj, 0, 1), gj, b)
    # The port takes the K-major view of the Q-major coef without a copy.
    got = mr.multiply_reduce_k(ct.transpose(0, 1), gt, b)
    assert got.dtype == tdt and got.shape == (q, b * c)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_flash_plain_matches_pallas_forward(dtype, h, hkv):
    from gaot_tpu.ops.pallas.flash_attention import _flash_forward

    jdt, tdt, rtol, atol = DTYPES[dtype]
    rng = np.random.default_rng(h + hkv)
    b, s, d = 2, 256, 32
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, jdt, tdt) for a in (q, k, v))
    hm = lambda x: jnp.transpose(x, (0, 2, 1, 3))
    with pltpu.force_tpu_interpret_mode():
        want = hm(_flash_forward(hm(qj), hm(kj), hm(vj), q_block=128))
    got = fa.flash_attention(qt, kt, vt)
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_flash_plain_ragged_sequence_matches_xla():
    """Any S: the plain version against the JAX einsum attention at S=100
    (a length the Pallas kernel does not take), GQA 6:2 heads."""
    from gaot_tpu.models.transformer import gqa_attention_xla

    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 100, 6, 32)).astype(np.float32)
    k = rng.normal(size=(1, 100, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, 100, 2, 32)).astype(np.float32)
    want = gqa_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r", [200, 256])
def test_fused_ffn_plain_matches_pallas(dtype, r):
    """r=200 is ragged against the kernel's 64-row tiles (the TPU pads)."""
    from gaot_tpu.ops.pallas.fused_ffn import _ffn_call

    jdt, tdt, rtol, atol = DTYPES[dtype]
    rng = np.random.default_rng(r)
    m, f = 128, 256
    x = (rng.normal(size=(r, m)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w3 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w2 = (rng.normal(size=(f, m)) / np.sqrt(f)).astype(np.float32)
    (xj, xt), (w1j, _), (w3j, _), (w2j, _) = (_both(a, jdt, tdt)
                                             for a in (x, w1, w3, w2))
    want = _ffn_call(xj, w1j, w3j, w2j, interpret=True)
    # torch Linear layouts: w1, w3 [F, M]; w2 [M, F].
    tw = lambda a: torch.from_numpy(np.ascontiguousarray(a.T)).to(tdt)
    got = ff.fused_ffn(xt, tw(w1), tw(w3), tw(w2))
    assert got.dtype == tdt and got.shape == (r, m)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_wrappers_validate_shapes():
    with pytest.raises(ValueError):
        mr.multiply_reduce_k(torch.zeros(2, 3, 4), torch.zeros(2, 3, 10), 2)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 2, 32),
                           torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError):
        ff.fused_ffn(torch.zeros(4, 8), torch.zeros(16, 8), torch.zeros(16, 8),
                     torch.zeros(16, 8))
