"""Attention dropout (``attn_config.atten_dropout``) in the port against the
JAX package, on the CPU.

- The keep mask by its statistics: with uniform softmax weights and V the
  identity, the output's non-zero share is the keep rate, within 4σ of
  1 − rate, and each kept weight is 1/(S·(1 − rate)).
- Results exactly: the mask ``jax.random.bernoulli(key, 1 − rate,
  [B, Hkv, G, S, S])`` draws is handed to the port's ``keep``; the output
  and the gradients of q, k and v match ``gqa_attention_xla`` with the
  same key (fp32 rtol 1e-5, atol 1e-5 of the largest entry; bf16 inputs
  within 1e-2 of the largest entry, as both round the weights to bf16).
- The whole GAOT in training with dropout, the JAX side's masks recorded
  as it draws them and handed to the port's layers in the same order: the
  forward and every parameter's gradient against ``jax.grad`` (fp32, rtol
  1e-5, atol 1e-5 of each tensor's largest entry).
- The route: ``plain-dropout`` in a training forward (given a generator) at
  a rate above 0; at rate 0, or without a generator (evaluation), the
  route is what it was.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

RATE = 0.1


def _qkv(b=2, s=16, h=4, hkv=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, hkv, hkv)]


def test_keep_rate_and_scale():
    from gaot_torch.models.transformer import attention_dropout

    b, s, h = 4, 64, 4
    q = torch.zeros(b, s, h, s)
    eye = torch.eye(s).expand(b, h, s, s).permute(0, 2, 1, 3)    # v[b, k, h] = e_k
    gen = torch.Generator().manual_seed(0)
    out = attention_dropout(q, q, eye.contiguous(), RATE, generator=gen)
    kept = out != 0
    n = kept.numel()
    rate = float(kept.float().mean())
    assert abs(rate - (1 - RATE)) <= 4 * np.sqrt(RATE * (1 - RATE) / n), rate
    torch.testing.assert_close(out[kept], torch.full((int(kept.sum()),),
                                                     1 / (s * (1 - RATE))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dropout_matches_jax(dtype):
    from gaot_torch.models.transformer import attention_dropout
    from gaot_tpu.models.transformer import gqa_attention_xla

    q, k, v = _qkv()
    b, s, h, _ = q.shape
    hkv = k.shape[2]
    key = jax.random.key(3)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - RATE, (b, hkv, h // hkv, s, s)))
    assert 0 < keep.mean() < 1
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b_, c: gqa_attention_xla(
        a, b_, c, RATE, deterministic=False, dropout_rng=key), jq, jk, jv)
    ct = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(ct).astype(jdt))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    got = attention_dropout(tq, tk, tv, RATE, keep=torch.from_numpy(keep.copy()))
    assert got.dtype == tdt
    got.backward(torch.from_numpy(ct).to(tdt))
    pairs = [(got, want)] + [(t.grad, w) for t, w in zip((tq, tk, tv), want_grads)]
    for g, w in pairs:
        w = np.asarray(w.astype(jnp.float32))
        g = g.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
        else:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()


def test_routes():
    from gaot_torch.models.transformer import GroupQueryAttention
    from gaot_torch.utils.routing import format_routes, reset_routes

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 32))
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    for rate, generator, route in ((RATE, gen, "plain-dropout"), (RATE, None, "plain"),
                                   (0.0, gen, "plain")):
        attn = GroupQueryAttention(32, 32, 4, 2, atten_dropout=rate, device="cpu")
        reset_routes()
        out = attn(x, generator=generator)
        assert format_routes() == f"attn={route}", (rate, generator)
        assert torch.isfinite(out).all()
    # A keep mask handed to the module: the same dropout, drawn by the caller.
    attn = GroupQueryAttention(32, 32, 4, 2, atten_dropout=RATE, device="cpu")
    state = gen.get_state()
    want = attn(x, generator=gen)
    gen.set_state(state)
    keep = torch.rand((2, 2, 2, 16, 16), generator=gen) < 1 - RATE
    reset_routes()
    torch.testing.assert_close(attn(x, keep=keep), want, rtol=0, atol=0)
    assert format_routes() == "attn=plain-dropout"


def test_gaot_with_attention_dropout_matches_jax(monkeypatch):
    """A GAOT (2 UViT layers, bucketed encoder) in training at rate 0.1: JAX
    draws its masks (recorded as drawn); the port's layers take them in the
    same order."""
    from gaot_torch.models import transformer as ttr
    from test_torch_edge_drop import (
        GRID,
        RADIUS,
        assert_matches,
        model_cfg,
        torch_model,
        torch_run,
        workload,
    )
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.core.config import ModelConfig, merge_config
    from gaot_tpu.models import GAOT
    from gaot_tpu.train.static_trainer import masked_mse

    cfg = model_cfg("fx_bucketed", GRID, RADIUS)
    cfg["args"]["transformer"]["attn_config"]["atten_dropout"] = RATE
    coords, lat, pn, tgt, _, (je, jd, jet, jdt), tgraphs = workload("fx_bucketed", cfg)
    model = GAOT(input_size=pn.shape[-1], output_size=tgt.shape[-1],
                 config=merge_config(ModelConfig, cfg))
    args = (jnp.asarray(lat), jnp.asarray(coords), jnp.asarray(pn), je, jd)
    kw = dict(encoder_tgraphs=jet, decoder_tgraphs=jdt)
    params = jax.jit(lambda key: model.init(key, *args, **kw))(jax.random.key(0))

    drawn = []
    bernoulli = jax.random.bernoulli

    def record(key, p, shape):
        keep = bernoulli(key, p, shape)
        drawn.append(keep)
        return keep

    def loss_fn(p):
        drawn.clear()
        pred = model.apply(p, *args, training=True, rngs={"dropout": jax.random.key(7)},
                           **kw)
        loss = masked_mse(pred, jnp.asarray(tgt), jnp.ones(pred.shape[0], bool))
        return loss, (pred, list(drawn))

    monkeypatch.setattr(jax.random, "bernoulli", record)
    (_, (want_pred, keeps)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    keeps = [torch.from_numpy(np.array(k)) for k in keeps]
    assert len(keeps) == 2 and all(0 < float(k.float().mean()) < 1 for k in keeps)

    plain = ttr.attention_dropout
    monkeypatch.setattr(ttr, "attention_dropout",
                        lambda q, k, v, rate, generator=None, keep=None:
                        plain(q, k, v, rate, keep=keeps.pop(0)))
    tm = torch_model(cfg, jax.tree.map(np.asarray, params))
    pred, got = torch_run(tm, coords, lat, pn, tgt, None, tgraphs,
                          generator=torch.Generator().manual_seed(0))
    assert not keeps
    assert_matches(pred, got, np.asarray(want_pred),
                   flax_to_torch_state_dict(jax.tree.map(np.asarray, grads)))
