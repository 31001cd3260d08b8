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
    counts = kernels.launch_counts()
    assert set(counts) == {"multiply_reduce_k", "multiply_reduce_b",
                           "flash_attention_fwd", "flash_attention_fwd_lse",
                           "flash_attention_bwd",
                           "fused_ffn_fwd", "fused_ffn_bwd"}
    assert not any(counts.values())


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


# (K, Q, b, C, coefficient form, masked slots and an output row map): the
# forward's form (coefficients per edge, every slot), and d_f's (a table
# read by a second index, masked slots, an all-masked row, rows written
# through a row map into a larger output) at the fx lanes and at the long
# path's narrow ones (b = 1, C = 16: the TPU kernel folds 8 queries).
_GATHER_K = [(5, 24, 4, 64, "per edge", False), (12, 16, 2, 64, "table", True),
             (8, 64, 1, 16, "table", True)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,q,b,c,form,masked", _GATHER_K)
def test_gather_multiply_reduce_k_plain_matches_pallas(dtype, k, q, b, c, form, masked):
    """The plain version of the index-reading reduce against the Pallas
    multiply_reduce_k on the rows it gathers (K-major, masked coefficients
    zeroed, as ``_nbc_bwd`` feeds it). Same tolerances."""
    from gaot_tpu.ops.pallas.multiply_reduce import multiply_reduce_k, supported

    jdt, tdt, rtol, atol = DTYPES[dtype]
    assert supported(q, b, c, 2)
    rng = np.random.default_rng(k * q + b)
    n, w = 40, b * c
    src = rng.normal(size=(n, w)).astype(np.float32)
    idx = rng.integers(0, n, size=(q, k))
    mask = np.ones((q, k), bool)
    if masked:
        mask = np.arange(k)[None] < rng.integers(0, k + 1, size=(q, 1))
        mask[3] = False                                 # a row with no edge
        idx = np.where(mask, idx, n + 7)                # out of range, never read
    if form == "table":
        table = rng.normal(size=(3 * q * k, c)).astype(np.float32)
        cidx = rng.integers(0, table.shape[0], size=(q, k))
        coef_qk = table[cidx]
    else:
        coef_qk = rng.normal(size=(q, k, c)).astype(np.float32)
    gath = np.transpose(src[np.where(mask, idx, 0)], (1, 0, 2))          # [K, Q, W]
    coef_km = np.transpose(np.where(mask[..., None], coef_qk, 0), (1, 0, 2))
    with pltpu.force_tpu_interpret_mode():
        want = multiply_reduce_k(jnp.asarray(coef_km, jdt), jnp.asarray(gath, jdt), b)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    kw = {}
    if form == "table":
        coef, kw["coef_idx"] = t(table).to(tdt), t(cidx)
    else:
        coef = t(coef_qk).to(tdt)
    if masked:
        row_map = rng.permutation(q + 5)[:q]
        kw.update(mask=t(mask), row_map=t(row_map), out=torch.zeros(q + 5, w, dtype=tdt))
    got = mr.gather_multiply_reduce_k(t(src).to(tdt), t(idx), coef, b, **kw)
    assert got.dtype == tdt
    if masked:
        assert got is kw["out"] and not got[row_map[3]].any()
        assert not got[np.setdiff1d(np.arange(q + 5), row_map)].any()
        got = got[row_map]
    assert got.shape == (q, w)
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
    idx = torch.zeros(3, 2, dtype=torch.long)
    with pytest.raises(ValueError):               # coef not [Q, K, C]
        mr.gather_multiply_reduce_k(torch.zeros(5, 8), idx, torch.zeros(2, 3, 4), 2)
    with pytest.raises(ValueError):               # a row map needs an output
        mr.gather_multiply_reduce_k(torch.zeros(5, 8), idx, torch.zeros(3, 2, 4), 2,
                                    row_map=torch.arange(3))
    with pytest.raises(ValueError):               # dout not [Q, W]
        mr.gather_multiply_reduce_b(torch.zeros(5, 8), idx, torch.zeros(2, 8), 2)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 2, 32),
                           torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError):
        ff.fused_ffn(torch.zeros(4, 8), torch.zeros(16, 8), torch.zeros(16, 8),
                     torch.zeros(16, 8))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [128, 384, 512, 640, 1024])
def test_fused_ffn_plain_matches_pallas_widths(dtype, m):
    """The plain SwiGLU forward at widths the kernels take besides 256: the
    tuned 128, 384 and 512 and two of the general route's (640, 1024),
    ragged R; the tolerances of the module."""
    from gaot_tpu.ops.pallas.fused_ffn import _ffn_call

    jdt, tdt, rtol, atol = DTYPES[dtype]
    rng = np.random.default_rng(m)
    r, f = 72, 256
    x = (rng.normal(size=(r, m)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w3 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w2 = (rng.normal(size=(f, m)) / np.sqrt(f)).astype(np.float32)
    (xj, xt), (w1j, _), (w3j, _), (w2j, _) = (_both(a, jdt, tdt)
                                             for a in (x, w1, w3, w2))
    want = _ffn_call(xj, w1j, w3j, w2j, interpret=True)
    tw = lambda a: torch.from_numpy(np.ascontiguousarray(a.T)).to(tdt)
    got = ff.fused_ffn(xt, tw(w1), tw(w3), tw(w2))
    assert got.dtype == tdt and got.shape == (r, m)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# (M, F) pairs around the JAX gate's weight budget (18·M·F ≤ 64 MiB): the
# widths 640-896 at F = 4M, and narrower F that take M to 1024, 4096, or F
# to 29056 at M = 128.
_GATE_MF = [(m, f) for m in range(64, 4161, 64)
            for f in (64, 128, 256, 896, 1024, 2048, 3584, 3712, 4096, 29056, 29184)]


@pytest.mark.parametrize("what", ["flash", "bfloat16", "float32"])
def test_kernel_widths_match_the_jax_gates(what):
    """The port's predicates equal the JAX package's gates, with no cap:
    every head dim the flash gates take at S = 128 (8 to 1024), and every
    (R, M, F) the SwiGLU gate takes, in both dtypes; the kernels take all
    of them."""
    from gaot_tpu.ops.pallas import flash_attention as jfa
    from gaot_tpu.ops.pallas import fused_ffn as jff

    if what == "flash":
        for d in range(1, 1025):
            assert fa.supports_head_dim(d) == jfa._supported(128, d), d
            assert fa.supports_head_dim(d) == jfa._bwd_supported(128, d), d
        assert fa.supports_head_dim(8192) and jfa._supported(128, 8192)
        return
    jdt, tdt = DTYPES[what][:2]
    for r in (1, 256, 65536):
        for m, f in _GATE_MF:
            assert ff.supported(r, m, f, tdt) == jff.supported(r, m, f, jdt), (r, m, f)
    for m, f in ((1024, 3584), (4096, 896), (128, 29056), (640, 2560)):
        assert ff.supported(256, m, f, tdt) > 0, (m, f)
