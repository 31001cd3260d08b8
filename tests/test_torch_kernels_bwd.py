"""The plain backward versions of the port's kernels, and the forward's LSE
output, against the JAX package's Pallas kernels run in interpret mode on
the CPU, as the JAX package's own kernel tests run them. CPU tensors take
the plain route and leave the launch counters at 0.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (same fp32 arithmetic, other
summation order); bf16 compares bf16 outputs of fp32 sums, so one bf16 ulp
(rtol 8e-3) plus an atol for values near zero; fp32 weight gradients
summed from bf16 operands agree to fp32 summation order.
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

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 8e-3, 1e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,q,b,c", [(5, 24, 4, 64), (12, 16, 2, 64)])
def test_multiply_reduce_b_plain_matches_pallas(dtype, k, q, b, c):
    from gaot_tpu.ops.pallas.multiply_reduce import multiply_reduce_b, supported

    jdt, tdt, rtol, atol = DTYPES[dtype]
    assert supported(q, b, c, 2)
    rng = np.random.default_rng(k * q)
    gath = rng.normal(size=(k, q, b * c)).astype(np.float32)
    dout = rng.normal(size=(q, b * c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = multiply_reduce_b(jnp.asarray(gath, jdt), jnp.asarray(dout, jdt), b, c)
    got = mr.multiply_reduce_b(torch.from_numpy(gath).to(tdt),
                               torch.from_numpy(dout).to(tdt), b)
    assert got.dtype == tdt and got.shape == (k, q, c)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,q,b,c", [(5, 64, 1, 16), (5, 40, 4, 16)])
def test_multiply_reduce_b_plain_matches_pallas_narrow(dtype, k, q, b, c):
    """The narrow lanes of the 3D paths: at b = 1 the TPU kernel folds 8
    adjacent queries into one 128-lane row (``_fold_r``); at b = 4, C = 16
    (W = 64) its gate would leave the reduce to XLA, and its kernel body
    runs here as it is. Same tolerances as above."""
    from gaot_tpu.ops.pallas.multiply_reduce import _fold_r, multiply_reduce_b

    jdt, tdt, rtol, atol = DTYPES[dtype]
    assert _fold_r(q, b, b * c) == (8 if b == 1 else 1)
    rng = np.random.default_rng(q + b)
    gath = rng.normal(size=(k, q, b * c)).astype(np.float32)
    dout = rng.normal(size=(q, b * c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = multiply_reduce_b(jnp.asarray(gath, jdt), jnp.asarray(dout, jdt), b, c)
    got = mr.multiply_reduce_b(torch.from_numpy(gath).to(tdt),
                               torch.from_numpy(dout).to(tdt), b)
    assert got.dtype == tdt and got.shape == (k, q, c)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,q,b,c", [(5, 24, 4, 64), (8, 64, 1, 16), (8, 40, 4, 16)])
def test_gather_multiply_reduce_b_plain_matches_pallas(dtype, k, q, b, c):
    """The plain version of the index-reading d_coef against the Pallas
    multiply_reduce_b on the rows it gathers (K-major), at the fx lanes and
    the 3D paths' narrow ones (b = 1 folds 8 queries on the TPU; at W = 64
    the kernel body runs as it is); random indices into n source rows, with
    repeats. The result is in the coefficient's [Q, K, C] layout. Same
    tolerances as above."""
    from gaot_tpu.ops.pallas.multiply_reduce import multiply_reduce_b

    jdt, tdt, rtol, atol = DTYPES[dtype]
    rng = np.random.default_rng(k + q * b)
    n = 30
    src = rng.normal(size=(n, b * c)).astype(np.float32)
    idx = rng.integers(0, n, size=(q, k))
    dout = rng.normal(size=(q, b * c)).astype(np.float32)
    gath = np.ascontiguousarray(np.transpose(src[idx], (1, 0, 2)))       # [K, Q, W]
    with pltpu.force_tpu_interpret_mode():
        want = multiply_reduce_b(jnp.asarray(gath, jdt), jnp.asarray(dout, jdt), b, c)
    got = mr.gather_multiply_reduce_b(torch.from_numpy(src).to(tdt), torch.from_numpy(idx),
                                      torch.from_numpy(dout).to(tdt), b)
    assert got.dtype == tdt and got.shape == (q, k, c)
    np.testing.assert_allclose(_np(got), np.transpose(_np(want), (1, 0, 2)),
                               rtol=rtol, atol=atol)


def _attention_inputs(h, hkv, jdt, tdt, seed, d=32):
    rng = np.random.default_rng(seed)
    b, s = 2, 128
    arrs = [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, hkv, hkv, h)]                        # q, k, v, dO
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _hm(x):
    return jnp.transpose(x, (0, 2, 1, 3))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_flash_lse_plain_matches_pallas(dtype, h, hkv):
    """The base-2 row LSE the forward keeps for training, against
    ``_flash_forward(..., with_lse=True)`` (``_attn_kernel_lse``)."""
    from gaot_tpu.ops.pallas.flash_attention import _flash_forward

    jdt, tdt, rtol, atol = DTYPES[dtype]
    (qj, kj, vj, _), (qt, kt, vt, _) = _attention_inputs(h, hkv, jdt, tdt, h + hkv)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_forward(_hm(qj), _hm(kj), _hm(vj), 128, with_lse=True)
    got_out, got_lse = fa.flash_attention_lse(qt, kt, vt)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (2, h, 128)
    np.testing.assert_allclose(_np(got_out), _np(_hm(out)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_lse.reshape(-1, 128).numpy(), np.asarray(lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [8, 16, 64, 128, 136, 256, 512, 1024])
def test_flash_lse_plain_matches_pallas_head_dims(dtype, d):
    """The output and base-2 row LSE of the plain forward against
    ``_flash_forward(..., with_lse=True)`` at head dims besides 24 and 32,
    those of the templated kernels and, above 128, of the routes with D at
    run time (the bf16 one streams D in chunks of 64 and owns output slices
    of 256, so 512 and 1024 take several of each; GQA 4:2); the tolerances
    of the module, the LSE at 1e-5."""
    from gaot_tpu.ops.pallas.flash_attention import _flash_forward

    jdt, tdt, rtol, atol = DTYPES[dtype]
    (qj, kj, vj, _), (qt, kt, vt, _) = _attention_inputs(4, 2, jdt, tdt, d, d=d)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_forward(_hm(qj), _hm(kj), _hm(vj), 128, with_lse=True)
    got_out, got_lse = fa.flash_attention_lse(qt, kt, vt)
    assert got_out.shape == (2, 128, 4, d) and got_lse.shape == (2, 4, 128)
    np.testing.assert_allclose(_np(got_out), _np(_hm(out)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_lse.reshape(-1, 128).numpy(), np.asarray(lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_flash_backward_plain_matches_pallas(dtype, h, hkv):
    """dQ, dK, dV of the plain backward against ``_flash_backward`` at
    S = 128 ≤ 1024 (the monolithic ``_attn_bwd_kernel``), from the same
    forward output O. bf16: the GQA partials are summed after rounding, so
    dK and dV may differ by one more bf16 ulp."""
    from gaot_tpu.ops.pallas.flash_attention import _flash_backward, _flash_forward

    jdt, tdt, rtol, atol = DTYPES[dtype]
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _attention_inputs(h, hkv, jdt, tdt, 3 * h + hkv)
    with pltpu.force_tpu_interpret_mode():
        out = _flash_forward(_hm(qj), _hm(kj), _hm(vj), 128)
        want = _flash_backward(_hm(qj), _hm(kj), _hm(vj), out, _hm(doj))
    ot = torch.from_numpy(np.array(_np(_hm(out)))).to(tdt)
    got = fa.flash_attention_bwd(qt, kt, vt, ot, dot)
    for name, g, w, t in zip("qkv", got, want, (qt, kt, vt)):
        assert g.dtype == tdt and g.shape == t.shape, name
        scale = 2 if (dtype == "bfloat16" and name != "q") else 1
        np.testing.assert_allclose(_np(g), _np(_hm(w)), rtol=scale * rtol,
                                   atol=scale * atol, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [136, 256, 512, 1024])
def test_flash_backward_plain_matches_pallas_head_dims(dtype, d):
    """dQ, dK, dV of the plain backward against ``_flash_backward`` at
    S = 128 at head dims above 128 (the routes with D at run time; in bf16
    dQ owns slices of 256 and dK/dV slices of 128, so 512 and 1024 take
    several), GQA 4:2, with the tolerances of
    :func:`test_flash_backward_plain_matches_pallas`."""
    from gaot_tpu.ops.pallas.flash_attention import _flash_backward, _flash_forward

    jdt, tdt, rtol, atol = DTYPES[dtype]
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _attention_inputs(4, 2, jdt, tdt, d, d=d)
    with pltpu.force_tpu_interpret_mode():
        out = _flash_forward(_hm(qj), _hm(kj), _hm(vj), 128)
        want = _flash_backward(_hm(qj), _hm(kj), _hm(vj), out, _hm(doj))
    ot = torch.from_numpy(np.array(_np(_hm(out)))).to(tdt)
    got = fa.flash_attention_bwd(qt, kt, vt, ot, dot)
    for name, g, w, t in zip("qkv", got, want, (qt, kt, vt)):
        assert g.dtype == tdt and g.shape == t.shape, name
        scale = 2 if (dtype == "bfloat16" and name != "q") else 1
        np.testing.assert_allclose(_np(g), _np(_hm(w)), rtol=scale * rtol,
                                   atol=scale * atol, err_msg=f"d{name}")


@pytest.mark.parametrize("r", [200, 256])
def test_fused_ffn_backward_plain_matches_pallas(r):
    """dx (bf16) and the fp32 dW1, dW3, dW2 of ``_ffn_bwd_call`` in bf16;
    r = 200 is ragged against the kernel's 64-row tiles (the TPU pads).
    dh1 and dh3 are rounded to bf16 from fp32 sums taken in another order,
    so a few of them land on the neighbouring bf16 value; each such entry
    moves a weight gradient by one bf16 ulp of itself times x: atol 2e-3 of
    the gradient's largest entry."""
    from gaot_tpu.ops.pallas.fused_ffn import _ffn_bwd_call

    rng = np.random.default_rng(r)
    m, f = 128, 256
    x = (rng.normal(size=(r, m)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w3 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w2 = (rng.normal(size=(f, m)) / np.sqrt(f)).astype(np.float32)
    dout = rng.normal(size=(r, m)).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = _ffn_bwd_call(bf(x), bf(w1), bf(w3), bf(w2), bf(dout), interpret=True)
    # torch Linear layouts: w1, w3 [F, M]; w2 [M, F].
    tw = lambda a: torch.from_numpy(np.ascontiguousarray(a.T)).bfloat16()
    tx = lambda a: torch.from_numpy(a).bfloat16()
    dx, dw1, dw3, dw2 = ff.fused_ffn_bwd(tx(x), tw(w1), tw(w3), tw(w2), tx(dout))
    assert dx.dtype == torch.bfloat16 and dw1.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), _np(want[0]), rtol=8e-3, atol=1e-2)
    for g, w in ((dw1, want[1]), (dw3, want[2]), (dw2, want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).T, rtol=1e-4,
                                   atol=2e-3 * float(np.abs(w).max()))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [128, 384, 512, 640, 1024])
def test_fused_ffn_backward_plain_matches_pallas_widths(dtype, m):
    """The plain backward at widths besides 256 (the tuned 128, 384, 512 and
    the general route's 640, 1024), ragged R, in both dtypes: bf16 with the
    tolerances of :func:`test_fused_ffn_backward_plain_matches_pallas`;
    fp32, where nothing is rounded to bf16, dx at the module's fp32
    tolerances and the weight gradients at rtol 1e-4 plus 1e-5 of their
    largest entry (fp32 sums over the rows in another order)."""
    from gaot_tpu.ops.pallas.fused_ffn import _ffn_bwd_call

    jdt, tdt, rtol, atol = DTYPES[dtype]
    bf = dtype == "bfloat16"
    rng = np.random.default_rng(m + 1)
    r, f = 72, 256
    x = (rng.normal(size=(r, m)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w3 = (rng.normal(size=(m, f)) / np.sqrt(m)).astype(np.float32)
    w2 = (rng.normal(size=(f, m)) / np.sqrt(f)).astype(np.float32)
    dout = rng.normal(size=(r, m)).astype(np.float32)
    jx = lambda a: jnp.asarray(a, jdt)
    want = _ffn_bwd_call(jx(x), jx(w1), jx(w3), jx(w2), jx(dout), interpret=True)
    tw = lambda a: torch.from_numpy(np.ascontiguousarray(a.T)).to(tdt)
    tx = lambda a: torch.from_numpy(a).to(tdt)
    dx, dw1, dw3, dw2 = ff.fused_ffn_bwd(tx(x), tw(w1), tw(w3), tw(w2), tx(dout))
    assert dx.dtype == tdt and dw1.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), _np(want[0]), rtol=rtol, atol=atol)
    for g, w in ((dw1, want[1]), (dw3, want[2]), (dw2, want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).T, rtol=1e-4,
                                   atol=(2e-3 if bf else 1e-5) * float(np.abs(w).max()))
