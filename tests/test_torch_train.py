"""The port's whole-model gradients against ``jax.grad`` of the JAX GAOT on
the CPU: the masked-MSE gradient of every parameter, by state-dict name,
from the same carried weights and batch (the tiny parity workload: bucketed
encoder with the grouped transpose graph, dense decoder with its transpose
graph, 3-layer UViT with GQA). The JAX gradient pytree is relabelled by
``flax_to_torch_state_dict``, the same map that carries the weights.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 of each tensor's largest entry (fp32
arithmetic in another order); bf16 a global relative L2 of 5e-2 over all
gradients (bf16 rounds at other places in XLA and PyTorch, and the port's
CPU FFN takes the fused kernel's rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp


def _jax_grads(dtype):
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.models import GAOT as JGAOT
    from gaot_tpu.train.static_trainer import masked_mse

    coords, lat, pndata, target = tp.workload()
    jcfg, _ = tp.configs()
    enc, dec, enc_t, dec_t = tp.jax_graphs(coords, lat, jcfg)
    model = JGAOT(input_size=tp.IN_CH, output_size=tp.OUT_CH, config=jcfg,
                  dtype=dtype)
    smask = jnp.ones(tp.BATCH, bool)
    key = jax.random.key(0)

    def loss_fn(p):
        pred = model.apply(p, jnp.asarray(lat), jnp.asarray(coords),
                           jnp.asarray(pndata), enc, dec, training=True,
                           rngs={"dropout": key, "edge_drop": key},
                           encoder_tgraphs=enc_t, decoder_tgraphs=dec_t)
        return masked_mse(pred, jnp.asarray(target), smask)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tp.jax_params())
    return float(loss), flax_to_torch_state_dict(jax.tree.map(np.asarray, grads))


def _torch_grads(dtype):
    from gaot_torch.train.static_trainer import FxGraphs, masked_mse

    coords, lat, pndata, target = tp.workload()
    _, tcfg = tp.configs()
    graphs = FxGraphs(torch.from_numpy(lat), *tp.torch_graphs(coords, lat, tcfg))
    model = tp.torch_model(dtype).train()
    pred = model(graphs.latent_tokens_coord, torch.from_numpy(coords),
                 torch.from_numpy(pndata), graphs.encoder, graphs.decoder,
                 encoder_tgraphs=graphs.encoder_t, decoder_tgraphs=graphs.decoder_t)
    loss = masked_mse(pred, torch.from_numpy(target),
                      torch.ones(tp.BATCH, dtype=torch.bool))
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}


def test_model_gradients_fp32_match_jax_grad():
    want_loss, want = _jax_grads(None)
    loss, got = _torch_grads(None)
    assert set(got) == set(want)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for name in sorted(want):
        w = want[name].reshape(got[name].shape)
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_model_gradients_bf16_match_jax_grad():
    want_loss, want = _jax_grads(jnp.bfloat16)
    loss, got = _torch_grads(torch.bfloat16)
    assert set(got) == set(want)
    assert loss == pytest.approx(want_loss, rel=2e-2)
    g = np.concatenate([got[n].reshape(-1) for n in sorted(want)])
    w = np.concatenate([want[n].reshape(-1) for n in sorted(want)])
    assert np.isfinite(g).all()
    assert tp.rel_l2(g, w) <= 5e-2
