"""The port's plain flash-attention forward, LSE and backward against the
JAX package's long-sequence Pallas regimes, run in interpret mode on the CPU
as the JAX package's own kernel tests run them, at head dims 24 (the 3D
flagship's) and 32, with GQA:

- ``_flash_backward``'s q-tiled branch (``_attn_bwd_tiled_kernel``, served
  for 1024 < S ≤ 4096), reached at S = 1024 by lowering
  ``_BWD_MONOLITHIC_MAX_S`` to 512 (q-tiles of 256 rows, four per head);
- ``_flash_backward_long`` (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``,
  served for S > 4096), called directly at S = 384 (three 128-row tiles),
  from the LSE of ``_flash_forward(with_lse=True)``;
- the forward and its base-2 LSE (``_attn_kernel_lse``).

The port has one plain backward, with ``_bwd_core``'s rounding. The long
backward rounds elsewhere (p from the LSE, the scale applied at the end of
dQ and dK); in bf16 that difference stays inside the tolerance below.

Tolerances, as ``tests/test_torch_kernels_bwd.py`` states them: fp32 rtol
1e-4 / atol 1e-5 (same fp32 arithmetic, other summation order); bf16 one
bf16 ulp (rtol 8e-3) plus an atol of 1e-2 for values near zero, doubled for
dK and dV, whose GQA partials are summed after rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gaot_torch.ops import cuda as kernels
from gaot_torch.ops.cuda import flash_attention as fa

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 8e-3, 1e-2)}
CASES = [(d, h, hkv, dtype) for d in (24, 32) for h, hkv in ((4, 2), (4, 4))
         for dtype in DTYPES]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _hm(x):
    return jnp.transpose(x, (0, 2, 1, 3))


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    assert not any(kernels.launch_counts().values())


def _inputs(s, d, h, hkv, dtype, seed):
    jdt, tdt = DTYPES[dtype][:2]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(1, s, n, d)).astype(np.float32)
            for n in (h, hkv, hkv, h)]                        # q, k, v, dO
    return ([_hm(jnp.asarray(a, jdt)) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _check_grads(got, want, tensors, dtype):
    tdt, rtol, atol = DTYPES[dtype][1:]
    for name, g, w, t in zip("qkv", got, want, tensors):
        assert g.dtype == tdt and g.shape == t.shape, name
        scale = 2 if (dtype == "bfloat16" and name != "q") else 1
        np.testing.assert_allclose(_np(g), _np(_hm(w)), rtol=scale * rtol,
                                   atol=scale * atol, err_msg=f"d{name}")


@pytest.mark.parametrize("d,h,hkv,dtype", CASES)
def test_flash_forward_lse_plain_matches_pallas(d, h, hkv, dtype):
    """Output and base-2 row LSE against ``_flash_forward(with_lse=True)``
    at S = 384 (three 128-row query blocks)."""
    from gaot_tpu.ops.pallas.flash_attention import _flash_forward

    _, tdt, rtol, atol = DTYPES[dtype]
    s = 384
    (qj, kj, vj, _), (qt, kt, vt, _) = _inputs(s, d, h, hkv, dtype, d + h + hkv)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_forward(qj, kj, vj, 128, with_lse=True)
    got_out, got_lse = fa.flash_attention_lse(qt, kt, vt)
    assert got_out.dtype == tdt and got_lse.shape == (1, h, s)
    np.testing.assert_allclose(_np(got_out), _np(_hm(out)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_lse.reshape(h, s).numpy(), np.asarray(lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,h,hkv,dtype", CASES)
def test_flash_backward_plain_matches_tiled_branch(monkeypatch, d, h, hkv, dtype):
    """dQ, dK, dV against ``_flash_backward``'s q-tiled branch at S = 1024
    with the monolithic cutoff lowered to 512."""
    from gaot_tpu.ops.pallas import flash_attention as jfa

    monkeypatch.setattr(jfa, "_BWD_MONOLITHIC_MAX_S", 512)
    s = 1024
    (qj, kj, vj, doj), ts = _inputs(s, d, h, hkv, dtype, 3 * d + h + hkv)
    with pltpu.force_tpu_interpret_mode():
        out = jfa._flash_forward(qj, kj, vj, 512)
        want = jfa._flash_backward(qj, kj, vj, out, doj)
    ot = torch.from_numpy(np.array(_np(_hm(out)))).to(ts[0].dtype)
    got = fa.flash_attention_bwd(ts[0], ts[1], ts[2], ot, ts[3])
    _check_grads(got, want, ts[:3], dtype)


@pytest.mark.parametrize("d,h,hkv,dtype", CASES)
def test_flash_backward_plain_matches_long_backward(d, h, hkv, dtype):
    """dQ, dK, dV against ``_flash_backward_long`` at S = 384, from the
    forward's output and LSE. The port's wrapper gets the forward's LSE as
    the training path hands it over."""
    from gaot_tpu.ops.pallas import flash_attention as jfa

    s = 384
    (qj, kj, vj, doj), ts = _inputs(s, d, h, hkv, dtype, 5 * d + h + hkv)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_forward(qj, kj, vj, 128, with_lse=True)
        want = jfa._flash_backward_long(qj, kj, vj, out, doj, lse)
    ot = torch.from_numpy(np.array(_np(_hm(out)))).to(ts[0].dtype)
    lt = torch.from_numpy(np.array(lse)).reshape(1, h, s)
    got = fa.flash_attention_bwd(ts[0], ts[1], ts[2], ot, ts[3], lt)
    _check_grads(got, want, ts[:3], dtype)
