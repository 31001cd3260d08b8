"""The port's fp32 forward and every parameter gradient against the JAX
GAOT's, on the CPU, across the model options: each case merges a few
options over ``torch_parity.MODEL_CFG``, builds both models on the tiny
parity workload (graphs built by each package from its own config), carries
the JAX weights over with a strict load, and compares the prediction and
``jax.grad`` of the masked MSE by state-dict name.

The nonlinear transforms run in the dense layout (the graph preparation
never buckets them) and on bucketed graphs built as for a linear transform
(the AGNO's per-bucket plain route); their dense decoder, and the dense
encoder, reach the per-sample-coefficient gather-multiply-reduce.

Tolerances are those of ``test_torch_gaot.py`` and ``test_torch_train.py``:
forward rtol 1e-4 / atol 1e-5, each gradient rtol 1e-4 / atol 1e-5 of its
tensor's largest entry (fp32 arithmetic in another order). The dot-product
attention's ``key_proj.bias`` gradient is zero in exact arithmetic (a
softmax over the keys is invariant to a shift shared by every key), so both
sides give rounding noise near 1e-12: it is held by atol 1e-5 of the
largest gradient of its AGNO's kernel MLP alone.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

_BUCKETED = {"use_query_bucketing": True}
_DENSE = {"use_query_bucketing": False}
_TWO = {"scales": [1.0, 1.5]}

# name: (MODEL_CFG overrides, bucket the graphs as for a linear transform)
CASES = {
    "two_scales_bucketed": ({"magno": {**_TWO, **_BUCKETED}}, False),
    "two_scales_dense": ({"magno": {**_TWO, **_DENSE}}, False),
    "two_scales_weighted_bucketed": (
        {"magno": {**_TWO, **_BUCKETED, "use_scale_weights": True}}, False),
    "two_scales_weighted_dense": (
        {"magno": {**_TWO, **_DENSE, "use_scale_weights": True}}, False),
    "dot_product_attention": ({"magno": {"attention_type": "dot_product"}}, False),
    "no_attention": ({"magno": {"use_attention": False}}, False),
    "no_geoembed": ({"magno": {"use_geoembed": False}}, False),
    "node_embedding": ({"magno": {"node_embedding": True}}, False),
    "linear_kernelonly": ({"magno": {"transform_type": "linear_kernelonly"}}, False),
    "no_bucketing": ({"magno": _DENSE}, False),
    "knn_2d": ({"magno": {"neighbor_strategy": "knn", "max_neighbors": 8}}, False),
    "mlp_layers_1": ({"magno": {"mlp_layers": 1}}, False),
    "nonlinear_dense": ({"magno": {"transform_type": "nonlinear"}}, False),
    "nonlinear_bucketed": ({"magno": {"transform_type": "nonlinear"}}, True),
    "nonlinear_kernelonly_dense": (
        {"magno": {"transform_type": "nonlinear_kernelonly"}}, False),
    "nonlinear_kernelonly_bucketed": (
        {"magno": {"transform_type": "nonlinear_kernelonly"}}, True),
    "rope": ({"transformer": {"positional_embedding": "rope"}}, False),
    "four_layers": ({"transformer": {"num_layers": 4}}, False),
    "no_long_range_skip": ({"transformer": {"use_long_range_skip": False}}, False),
    "no_norms": ({"transformer": {"use_attn_norm": False, "use_ffn_norm": False}},
                 False),
    "fused_ffn_on": ({"transformer": {"fused_ffn": "on"}}, False),
    "one_kv_head": ({"transformer": {"attn_config": {"num_heads": 4,
                                                     "num_kv_heads": 1}}}, False),
    "attn_backend_xla": ({"transformer": {"attn_backend": "xla"}}, False),
    "ffn_multiplier_2": ({"transformer": {"ffn_multiplier": 2}}, False),
}


def _merge(base, over):
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _graphs(pkg, coords, lat, magno, bucket_as_linear, **kw):
    """(enc, dec, enc_t, dec_t) of one package from its own config; with
    bucket_as_linear the graphs are prepared as for a linear transform."""
    import dataclasses
    import importlib

    gb = importlib.import_module(f"{pkg}.data.graph_builder")
    enc, dec = gb.GraphBuilder.from_magno_config(magno).build_fx_graphs(
        coords, lat, magno.radius, magno.scales)
    prep = (dataclasses.replace(magno, transform_type="linear")
            if bucket_as_linear else magno)
    return gb.prepare_fx_device_graphs(enc, dec, coords.shape[0], lat.shape[0],
                                       prep, **kw)


def _jax_run(cfg, bucket_as_linear):
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.core.config import ModelConfig, merge_config
    from gaot_tpu.models import GAOT
    from gaot_tpu.train.static_trainer import masked_mse

    coords, lat, pndata, target = tp.workload()
    jcfg = merge_config(ModelConfig, cfg)
    enc, dec, enc_t, dec_t = _graphs("gaot_tpu", coords, lat, jcfg.args.magno,
                                     bucket_as_linear)
    model = GAOT(input_size=tp.IN_CH, output_size=tp.OUT_CH, config=jcfg)
    args = (jnp.asarray(lat), jnp.asarray(coords), jnp.asarray(pndata), enc, dec)
    kw = dict(encoder_tgraphs=enc_t, decoder_tgraphs=dec_t)
    params = jax.jit(lambda key: model.init(key, *args, **kw))(jax.random.key(0))
    smask = jnp.ones(tp.BATCH, bool)

    def loss_fn(p):
        pred = model.apply(p, *args, training=True, **kw)
        return masked_mse(pred, jnp.asarray(target), smask), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    params, pred, grads = jax.tree.map(np.asarray, (params, pred, grads))
    return params, pred, flax_to_torch_state_dict(grads)


def _torch_run(cfg, params, bucket_as_linear):
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.models import GAOT
    from gaot_torch.train.static_trainer import masked_mse
    from gaot_torch.utils.torch_interop import load_flax_params

    coords, lat, pndata, target = tp.workload()
    tcfg = merge_config(ModelConfig, cfg)
    enc, dec, enc_t, dec_t = _graphs("gaot_torch", coords, lat, tcfg.args.magno,
                                     bucket_as_linear, device="cpu")
    model = GAOT(tp.IN_CH, tp.OUT_CH, tcfg, device="cpu")
    load_flax_params(model, params)
    model.train()
    pred = model(torch.from_numpy(lat), torch.from_numpy(coords),
                 torch.from_numpy(pndata), enc, dec, encoder_tgraphs=enc_t,
                 decoder_tgraphs=dec_t)
    masked_mse(pred, torch.from_numpy(target),
               torch.ones(tp.BATCH, dtype=torch.bool)).backward()
    return tp.to_np(pred), {n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_option_matches_jax_fp32(name):
    over, bucket_as_linear = CASES[name]
    cfg = _merge(tp.MODEL_CFG, {"args": over})
    params, want_pred, want = _jax_run(cfg, bucket_as_linear)
    pred, got = _torch_run(cfg, params, bucket_as_linear)
    assert pred.shape == want_pred.shape == (tp.BATCH, tp.NUM_NODES, tp.OUT_CH)
    np.testing.assert_allclose(pred, want_pred, rtol=1e-4, atol=1e-5)
    assert set(got) == set(want)
    for n in sorted(want):
        w = want[n].reshape(got[n].shape)
        if n.endswith("key_proj.bias"):
            mlp = n.rsplit(".", 2)[0] + ".channel_mlp."
            ref = max(float(np.abs(v).max()) for k, v in want.items()
                      if k.startswith(mlp))
            np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-5 * ref,
                                       err_msg=n)
            continue
        np.testing.assert_allclose(got[n], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=n)
