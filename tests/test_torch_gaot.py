"""The port's full fx GAOT forward and evaluation step against gaot_tpu on
the CPU: bucketed encoder, dense decoder with transpose graphs, 3-layer
UViT, JAX weights carried over."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp


def _jax_forward(dtype, with_loss=False):
    from gaot_tpu.models import GAOT as JGAOT
    from gaot_tpu.train.static_trainer import masked_mse

    coords, lat, pndata, target = tp.workload()
    jcfg, _ = tp.configs()
    enc, dec, enc_t, dec_t = tp.jax_graphs(coords, lat, jcfg)
    model = JGAOT(input_size=tp.IN_CH, output_size=tp.OUT_CH, config=jcfg,
                  dtype=dtype)

    @jax.jit
    def fwd(params, pndata, target, smask):
        pred = model.apply(params, jnp.asarray(lat), jnp.asarray(coords), pndata,
                           enc, dec, encoder_tgraphs=enc_t, decoder_tgraphs=dec_t)
        return pred, masked_mse(pred, target, smask)

    smask = np.array([True, False])
    pred, loss = fwd(tp.jax_params(), jnp.asarray(pndata), jnp.asarray(target),
                     jnp.asarray(smask))
    return np.asarray(pred.astype(jnp.float32)), float(loss), smask


def _torch_eval(dtype, smask):
    from gaot_torch.train.static_trainer import FxGraphs, eval_step

    coords, lat, pndata, target = tp.workload()
    _, tcfg = tp.configs()
    enc, dec, enc_t, dec_t = tp.torch_graphs(coords, lat, tcfg)
    graphs = FxGraphs(torch.from_numpy(lat), enc, dec, enc_t, dec_t)
    model = tp.torch_model(dtype)
    pred, loss = eval_step(model, graphs, torch.from_numpy(coords),
                           torch.from_numpy(pndata), torch.from_numpy(target),
                           torch.from_numpy(smask))
    return tp.to_np(pred), float(loss)


def test_gaot_forward_fp32_and_eval_step():
    """fp32: rtol 1e-4 / atol 1e-5 (summation order and transcendental
    rounding only). The masked MSE of eval_step agrees to fp32 rounding."""
    want, want_loss, smask = _jax_forward(None)
    got, loss = _torch_eval(None, smask)
    assert got.shape == want.shape == (tp.BATCH, tp.NUM_NODES, tp.OUT_CH)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)


def test_gaot_forward_bf16():
    """bf16 compute: relative L2 ≤ 2e-2. bf16 rounds at different places in
    XLA and PyTorch (and the port's CPU FFN takes the fused kernel's
    rounding: fp32 h1/h3, z in bf16), so only a bf16-level bound holds."""
    want, want_loss, smask = _jax_forward(jnp.bfloat16)
    got, loss = _torch_eval(torch.bfloat16, smask)
    assert np.isfinite(got).all()
    assert tp.rel_l2(got, want) <= 2e-2
    assert abs(loss - want_loss) <= 2e-2 * abs(want_loss)


def test_masked_mse_matches():
    from gaot_torch.train.static_trainer import masked_mse
    from gaot_tpu.train.static_trainer import masked_mse as jmasked_mse

    rng = np.random.default_rng(7)
    pred = rng.normal(size=(3, 40, 2)).astype(np.float32)
    target = rng.normal(size=(3, 40, 2)).astype(np.float32)
    smask = np.array([True, True, False])
    nmask = rng.random((3, 40)) > 0.3
    for nm in (None, nmask):
        want = float(jmasked_mse(jnp.asarray(pred), jnp.asarray(target),
                                 jnp.asarray(smask),
                                 None if nm is None else jnp.asarray(nm)))
        got = float(masked_mse(torch.from_numpy(pred), torch.from_numpy(target),
                               torch.from_numpy(smask),
                               None if nm is None else torch.from_numpy(nm)))
        assert got == pytest.approx(want, rel=1e-6)
