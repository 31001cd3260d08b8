"""The pointnet geometric embedding (``magno.embedding_method: "pointnet"``)
in the port against the JAX package, on the CPU, for each pooling (max,
mean, sum).

- The embedding alone on a padded graph with twin nodes (two nodes on one
  point, so max pooling meets ties: both JAX's ``jnp.max`` and the port's
  ``amax`` split a tie's gradient evenly) and rows with no valid edge
  (zeros): the forward, the gradient of the node coordinates and of the
  queries, and every parameter's gradient, fp32 rtol 1e-5, atol 1e-5 of
  each tensor's largest entry.
- The whole GAOT with the JAX weights loaded strictly (``geoembed.
  pointnet_mlp.0``, ``.2``, ``geoembed.fc.0``), on fx dense and bucketed
  graphs (a corner of latent rows without edges) and on a vx batch with
  bucketed graphs (the embedding reading the AGNO's coordinate rows), twin
  nodes on every layout; max pooling on each layout, mean on the fx
  buckets, sum on the vx ones: the forward and every parameter's gradient
  against ``jax.grad``, under the same bounds (the UViT's query and key
  projections by their attention block's largest projection gradient, as
  ``tests/test_torch_edge_drop.py::assert_matches`` says why).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_edge_drop import (  # noqa: E402
    GRID,
    RADIUS,
    VX_GRID,
    VX_RADIUS,
    assert_matches,
    jax_run,
    model_cfg,
    torch_model,
    torch_run,
    workload,
)

POOLINGS = ("max", "mean", "sum")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("pooling", POOLINGS)
def test_pointnet_embedding_matches_jax(pooling):
    from gaot_torch.models.gemb import GeometricEmbedding
    from gaot_torch.ops.padding import PaddedGraph
    from gaot_tpu.models.gemb import GeometricEmbedding as JGeometricEmbedding
    from gaot_tpu.ops import PaddedGraph as JPaddedGraph
    from gaot_tpu.ops import pad_csr, radius_search

    rng = np.random.default_rng(0)
    nodes = rng.uniform(-1, 0.5, (120, 2)).astype(np.float32)
    nodes[-20:] = nodes[:20]                                   # twins: ties
    ax = np.linspace(-1, 1, 8)
    lat = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    g = pad_csr(*radius_search(nodes, lat, 0.35))
    assert (~g.mask.any(-1)).any() and g.mask.any(-1).any()  # empty rows too
    jmod = JGeometricEmbedding(output_dim=16, method="pointnet", pooling=pooling)
    jg = JPaddedGraph(jnp.asarray(g.indices), jnp.asarray(g.mask))
    params = jmod.init(jax.random.key(1), jnp.asarray(nodes), jnp.asarray(lat), jg)
    ct = rng.normal(size=(lat.shape[0], 16)).astype(np.float32)

    def fn(p, y, x):
        return jnp.sum(jmod.apply(p, y, x, jg) * ct), jmod.apply(p, y, x, jg)

    (_, want), (dp, dy, dx) = jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(nodes), jnp.asarray(lat))

    tmod = GeometricEmbedding(2, 16, method="pointnet", pooling=pooling, device="cpu")
    p = jax.tree.map(np.asarray, params["params"])
    names = {"pointnet_mlp.0": p["pointnet_mlp"]["dense_0"],
             "pointnet_mlp.2": p["pointnet_mlp"]["dense_1"], "fc.0": p["fc"]}
    tmod.load_state_dict({f"{k}.{w}": torch.from_numpy(
        v["kernel"].T.copy() if w == "weight" else v["bias"].copy())
        for k, v in names.items() for w in ("weight", "bias")}, strict=True)
    y = torch.from_numpy(nodes).requires_grad_(True)
    x = torch.from_numpy(lat).requires_grad_(True)
    got = tmod(y, x, PaddedGraph(torch.from_numpy(g.indices), torch.from_numpy(g.mask)))
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got, want)
    assert not got[~torch.from_numpy(g.mask).any(-1)].any()
    _close(y.grad, dy)
    _close(x.grad, dx)
    if pooling == "max":
        # Each twin takes half of what their shared point gets.
        assert torch.equal(y.grad[:20], y.grad[-20:]) and y.grad[:20].any()
    dpp = jax.tree.map(np.asarray, dp["params"])
    for k, v in {"pointnet_mlp.0": dpp["pointnet_mlp"]["dense_0"],
                 "pointnet_mlp.2": dpp["pointnet_mlp"]["dense_1"],
                 "fc.0": dpp["fc"]}.items():
        mod = tmod.get_submodule(k)
        _close(mod.weight.grad, v["kernel"].T)
        _close(mod.bias.grad, v["bias"])


# Max pooling on every layout, mean and sum on one each (the embedding
# alone takes every pooling above).
CASES = [("fx_dense", "max"), ("fx_bucketed", "max"), ("vx_bucketed", "max"),
         ("fx_bucketed", "mean"), ("vx_bucketed", "sum")]


@pytest.mark.parametrize("layout,pooling", CASES)
def test_pointnet_gaot_matches_jax(layout, pooling):
    vx = layout.startswith("vx")
    cfg = model_cfg(layout, VX_GRID if vx else GRID, VX_RADIUS if vx else RADIUS,
                    embedding_method="pointnet", pooling=pooling)
    coords, lat, pn, tgt, nmask, jgraphs, tgraphs = workload(layout, cfg, twins=10)
    assert type(tgraphs[0][0]).__name__ == {"fx_dense": "PaddedGraph",
                                            "fx_bucketed": "BucketedGraph",
                                            "vx_bucketed": "FlatGraph"}[layout]
    params, want_pred, want = jax_run(cfg, coords, lat, pn, tgt, nmask, jgraphs)
    model = torch_model(cfg, params)
    assert "encoder.geoembed.pointnet_mlp.0.weight" in model.state_dict()
    pred, got = torch_run(model, coords, lat, pn, tgt, nmask, tgraphs)
    assert_matches(pred, got, want_pred, want)
