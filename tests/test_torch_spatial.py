"""Spatial (query) parallelism of the port (``gaot_torch/parallel/spatial.py``)
on the CPU, two ranks over gloo (``tests/torch_dist.py``), against the JAX
package's ``spatial_sharding`` on a (1, 2) mesh of the conftest's virtual
devices and against one process:

- the model of ``tests/test_spatial.py::_build_model`` (8x8 latent grid, 96
  nodes, batch 4, patch 2, 4 heads), with the absolute embedding and with
  RoPE: the forward and every gradient of the mean squared error equal
  JAX's under ``spatial_sharding`` within 1e-5 of each tensor's largest
  entry;
- the trainer with ``spatial_parallel`` at mp = 2, and on four ranks beside
  data parallelism (dp 2 × sp 2) and tensor parallelism (dp 2 × tp 2): two
  steps, the gradients, the validation loss and the test metric equal one
  process's within 1e-5 (the summation order of the sharded reductions
  differs);
- what it refuses: a grid whose first axis is not a whole number of patches
  per rank; vx data, refused until spatial parallelism covered it, now
  trains a step (``tests/test_torch_spatial_vx.py`` holds it).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist as td  # noqa: E402
from test_torch_parallel import _close, _config, _vx_config  # noqa: E402

MODEL = {   # tests/test_spatial.py::_build_model
    "latent_tokens_size": [8, 8],
    "args": {
        "magno": {"coord_dim": 2, "radius": 0.4, "hidden_size": 8,
                  "mlp_layers": 1, "lifting_channels": 8},
        "transformer": {"patch_size": 2, "hidden_size": 16, "num_layers": 3,
                        "attn_config": {"num_heads": 4, "num_kv_heads": 4}},
    },
}


def _jax_run(model_cfg):
    """JAX's forward and gradients under spatial_sharding on a (1, 2) mesh,
    and the model's host graphs, inputs and weights (torch names)."""
    import jax
    import jax.numpy as jnp

    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.core.config import ModelConfig, merge_config
    from gaot_tpu.models import GAOT
    from gaot_tpu.ops import PaddedGraph, pad_csr, radius_search
    from gaot_tpu.parallel import make_mesh, spatial_sharding

    grid, n, b = 8, 96, 4
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    lat = np.stack(np.meshgrid(np.linspace(-1, 1, grid), np.linspace(-1, 1, grid),
                               indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    enc = pad_csr(*radius_search(coords, lat, 0.4))
    dec = pad_csr(*radius_search(lat, coords, 0.4))
    to_dev = lambda g: PaddedGraph(jnp.asarray(g.indices), jnp.asarray(g.mask))
    model = GAOT(input_size=2, output_size=1, config=merge_config(ModelConfig, model_cfg))
    pndata = rng.normal(size=(b, n, 2)).astype(np.float32)
    target = np.random.default_rng(5).normal(size=(b, n, 1)).astype(np.float32)
    args = (jnp.asarray(lat), jnp.asarray(coords), jnp.asarray(pndata),
            [to_dev(enc)], [to_dev(dec)])
    params = jax.jit(model.init)(jax.random.key(0), *args)

    def loss_fn(p):
        pred = model.apply(p, *args)
        return jnp.mean((pred - target) ** 2), pred

    with jax.set_mesh(make_mesh(1, 2)), spatial_sharding():
        grads, pred = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    sd = lambda t: flax_to_torch_state_dict(jax.tree.map(np.asarray, t))
    return (np.asarray(pred), sd(grads), sd(params), (enc, dec),
            (lat, coords, pndata, target))


@pytest.mark.parametrize("embedding", ["absolute", "rope"])
def test_spatial_forward_and_grads_match_jax(tmp_path, embedding):
    import copy

    model_cfg = copy.deepcopy(MODEL)
    model_cfg["args"]["transformer"]["positional_embedding"] = embedding
    pred, grads, params, graphs, inputs = _jax_run(model_cfg)
    weights = td.save_weights(params, str(tmp_path / "w.pt"))
    ranks = td.run_ranks(td.spatial_model, 2, tmp_path, model_cfg, weights, graphs, inputs)
    one = td.spatial_model(0, 1, model_cfg, weights, graphs, inputs)
    for r in ranks:
        _close({"pred": r["pred"]}, {"pred": pred}, 1e-5, "forward vs JAX")
        _close(r["grads"], grads, 1e-5, "grads vs JAX")
        _close(r["grads"], one["grads"], 1e-5, "grads vs one process")


MESHES = {   # world: setup
    "sp2": (2, {"data_parallel": 1, "model_parallel": 2, "spatial_parallel": True}),
    "dp2xsp2": (4, {"data_parallel": 2, "model_parallel": 2, "spatial_parallel": True}),
    "dp2xtp2": (4, {"data_parallel": 2, "model_parallel": 2}),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_trainer_on_a_mesh_matches_one_process(tmp_path, mesh):
    world, setup = MESHES[mesh]
    model = {"transformer": {"positional_embedding": "rope"}} if mesh == "sp2" else None
    cfg = _config(tmp_path, "mesh", setup=setup, model=model)
    cfg1 = dict(cfg, setup=dict(cfg["setup"], data_parallel=-1, model_parallel=1,
                                spatial_parallel=False))
    ranks = td.run_ranks(td.steps_and_evaluate, world, tmp_path, cfg, None, 2)
    one = td.steps_and_evaluate(0, 1, cfg1, None, 2)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        _close(r["grads"], one["grads"], 1e-5, "grads")
        _close(r["weights"], one["weights"], 1e-5, "weights", base=None)
        assert r["eval"]["val"] == pytest.approx(one["eval"]["val"], rel=1e-5)
        assert r["eval"]["metric"] == pytest.approx(one["eval"]["metric"], rel=1e-5)


def test_spatial_refusals(tmp_path):
    from gaot_torch.parallel.spatial import spatial_shard

    with pytest.raises(ValueError, match="whole patches"):
        spatial_shard((12, 8), 2, 100, None, 0, 4)
    sp = spatial_shard((8, 8), 2, 10, None, 3, 4)
    assert (sp.latent, sp.tokens, sp.nodes, sp.grid) == ((48, 64), (12, 16), (9, 10), (2, 8))
    # vx data is no longer refused: its config trains a step on two ranks
    # (tests/test_torch_spatial_vx.py holds it against one process).
    cfg = _vx_config(tmp_path, "vxsp", setup={"data_parallel": 1, "model_parallel": 2,
                                             "spatial_parallel": True})
    for r in td.run_ranks(td.train_steps, 2, tmp_path, cfg, None, 1):
        assert np.isfinite(r["losses"]).all()
