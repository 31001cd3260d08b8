"""Training without transpose graphs (``magno.use_transpose_backward``
false) in the port against the JAX package, on the CPU.

With the flag off the JAX package builds no transpose graph and leaves d_f
to XLA's autodiff (a scatter-add) on its plain routes; the port keeps the
forward and d_coef on the multiply-reduce and takes d_f by a scatter
(``gaot_torch/ops/gather_apply.py::_scatter_df``).

- The GAOT on graphs built with the flag off, fx dense, fx bucketed, vx
  dense and vx bucketed, each without and with an edge-dropped mask (the
  port's draw, given to both sides as in ``tests/test_torch_edge_drop.py``):
  the forward and every parameter gradient against ``jax.grad``, fp32,
  within ``tests/test_torch_vx.py``'s bounds (forward rtol 1e-4 / atol
  1e-5, each gradient within 1e-4 of its tensor's largest entry).
- The reduce's d_f without a transpose graph, on vx graphs whose masks have
  holes, against ``jax.vjp`` of the JAX package's plain route and against
  the port's own d_f over the in-degree-grouped transpose graph (rtol 1e-4
  / atol 1e-5).
- A two-epoch ``StaticTrainer`` fit from JAX's initial weights against
  JAX's fit, both with the flag off, at ``tests/test_torch_trainer.py``'s
  sizes and bounds.
"""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_edge_drop as ed  # noqa: E402
from synthetic import make_static_fx_dataset  # noqa: E402
from test_torch_vx import _graphs as vx_graphs  # noqa: E402
from test_torch_vx import _split as vx_split  # noqa: E402
from test_train_e2e import TINY_MODEL, TINY_OPT, _paths  # noqa: E402

RTOL, ATOL, GRAD = 1e-4, 1e-5, 1e-4
OFF = {"use_transpose_backward": False}


def _check(pred, grads, want_pred, want):
    np.testing.assert_allclose(pred, want_pred, rtol=RTOL, atol=ATOL)
    assert grads.keys() == want.keys()
    for n, w in want.items():
        w = w.reshape(grads[n].shape)
        err = np.abs(grads[n] - w).max()
        assert err <= GRAD * max(np.abs(w).max(), 1e-30), (n, err)


def _jax_runner(cfg, coords, lat, pn, tgt, nmask):
    """JAX's initial parameters, its evaluation-mode forward and ``jax.grad``
    of the masked MSE as one jitted function of the graphs, so that graphs
    of the same shapes (the dropped masks) reuse its compilation."""
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.core.config import ModelConfig, merge_config
    from gaot_tpu.models import GAOT
    from gaot_tpu.train.static_trainer import masked_mse

    model = GAOT(input_size=ed.IN_CH, output_size=ed.OUT_CH,
                 config=merge_config(ModelConfig, cfg))
    nm = None if nmask is None else jnp.asarray(nmask)
    data = (jnp.asarray(lat), jnp.asarray(coords), jnp.asarray(pn))

    @jax.jit
    def run(graphs):
        je, jd, jet, jdt = graphs
        kw = dict(encoder_tgraphs=jet, decoder_tgraphs=jdt)
        params = model.init(jax.random.key(0), *data, je, jd, **kw)

        def loss_fn(p):
            pred = model.apply(p, *data, je, jd, training=False, **kw)
            return masked_mse(pred, jnp.asarray(tgt), jnp.ones(ed.B, bool), nm), pred

        (_, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return params, pred, grads

    def call(graphs):
        params, pred, grads = jax.tree.map(np.asarray, run(tuple(graphs)))
        return params, pred, flax_to_torch_state_dict(grads)
    return call


@pytest.mark.parametrize("layout", ["fx_dense", "fx_bucketed", "vx_dense", "vx_bucketed"])
def test_gaot_without_transpose_graphs_matches_jax(layout):
    from gaot_torch.utils.routing import format_routes, reset_routes

    vx = layout.startswith("vx")
    cfg = ed.model_cfg(layout, ed.VX_GRID if vx else ed.GRID,
                       ed.VX_RADIUS if vx else ed.RADIUS, sampling_strategy="ratio",
                       sample_ratio=0.5, **OFF)
    coords, lat, pn, tgt, nmask, jgraphs, tgraphs = ed.workload(layout, cfg)
    te, td, tet, tdt = tgraphs
    assert tet is None and tdt is None
    assert all(getattr(g, "tgraph", None) is None for g in te + td)
    if layout.endswith("bucketed"):
        assert any(len(getattr(g, "buckets", ())) > 1 for g in te + td)
    jax_run = _jax_runner(cfg, coords, lat, pn, tgt, nmask)
    params, want_pred, want = jax_run(jgraphs)
    model = ed.torch_model(cfg, params)
    reset_routes()
    pred, grads = ed.torch_run(model, coords, lat, pn, tgt, nmask, tgraphs)
    assert ":scatter-df" in format_routes(), format_routes()
    _check(pred, grads, want_pred, want)

    # The same with the masks of one edge drop on both sides.
    dropped = ed.drop_graphs(model, tgraphs, torch.Generator().manual_seed(11))
    assert any(not torch.equal(a, d) for b, a_ in zip(te + td, dropped[0] + dropped[1])
               for a, d in zip(ed.masks(b), ed.masks(a_)))
    jd = (*[[ed.with_masks(j, t) for j, t in zip(jgraphs[i], dropped[i])]
            for i in (0, 1)], jgraphs[2], jgraphs[3])
    _, want_pred, want = jax_run(jd)
    pred, grads = ed.torch_run(model, coords, lat, pn, tgt, nmask, dropped)
    _check(pred, grads, want_pred, want)


@pytest.mark.parametrize("bucketing", [True, False], ids=["bucketed", "dense"])
def test_reduce_df_without_transpose_graph(bucketing):
    """d_f by the scatter on masks with holes (a third of the edges
    dropped, their coefficients zero as the AGNO folds them): against
    ``jax.vjp`` of the JAX package's plain route, and against the port's d_f
    over the transpose graph; the forward and d_coef alike."""
    from gaot_torch.ops.gather_apply import flat_gather_multiply_reduce
    from gaot_tpu.ops.gather_apply import apply_graph_transform
    from gaot_tpu.ops.padding import PaddedGraph

    split, lat, bufs = vx_split(bucketing)
    te, _ = vx_graphs(bufs, False)
    vg = te[0]
    assert vg.tgraph is not None
    rng = np.random.default_rng(17)
    masks = [g.mask.numpy() & (rng.uniform(size=g.mask.shape) > 1 / 3)
             for g in vg.buckets]
    vg = vg._replace(buckets=tuple(g._replace(mask=torch.from_numpy(m))
                                   for g, m in zip(vg.buckets, masks)))
    coefs = [(rng.normal(size=(*m.shape, ed.C)) * m[..., None]).astype(np.float32)
             for m in masks]
    n = ed.B * split.coords.shape[1]
    f = rng.normal(size=(n, ed.C)).astype(np.float32)
    ct = rng.normal(size=(ed.B * vg.rows, ed.C)).astype(np.float32)
    # The port's rows are sample-major; the buckets' rows concatenated.
    rj = [g.indices.shape[0] // ed.B for g in vg.buckets]
    base = np.concatenate([[0], np.cumsum(rj)])
    to_bm = np.concatenate([(np.arange(ed.B)[:, None] * vg.rows + base[j]
                             + np.arange(rj[j])[None]).reshape(-1)
                            for j in range(len(rj))])
    jidx = [jnp.asarray(g.indices.numpy()) for g in vg.buckets]

    def jfn(cs, fv):
        return jnp.concatenate([apply_graph_transform(c, fv, PaddedGraph(i, None))
                                for c, i in zip(cs, jidx)], 0)

    out, vjp = jax.vjp(jfn, tuple(jnp.asarray(c) for c in coefs), jnp.asarray(f))
    d_coefs, d_f = vjp(jnp.asarray(ct[to_bm]))
    res = {}
    for name, g in (("scatter", vg._replace(tgraph=None)), ("tgraph", vg)):
        cls = [torch.from_numpy(c).requires_grad_(True) for c in coefs]
        fl = torch.from_numpy(f).requires_grad_(True)
        got = flat_gather_multiply_reduce(cls, fl, g)
        got.backward(torch.from_numpy(ct))
        res[name] = (got.detach()[torch.from_numpy(to_bm)].numpy(),
                     [c.grad.numpy() for c in cls], fl.grad.numpy())
    for got, dc, df in res.values():
        np.testing.assert_allclose(got, np.asarray(out), rtol=RTOL, atol=ATOL)
        for a, b in zip(dc, d_coefs):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(df, np.asarray(d_f), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res["scatter"][2], res["tgraph"][2], rtol=RTOL, atol=ATOL)


def test_fit_without_transpose_graphs_matches_jax(tmp_path):
    """The two-epoch fx fit with the flag off, from JAX's initial weights:
    the loss records within rtol 2e-4, the relative error within rtol 1e-3,
    each parameter within 1e-3 of its tensor's largest entry."""
    from gaot_torch.train import StaticTrainer
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, load_flax_params
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    make_static_fx_dataset(str(tmp_path / "toy.npz"))
    cfgs = {}
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        model = copy.deepcopy(TINY_MODEL)
        model["args"]["magno"].update(OFF)
        cfgs[side] = {
            "setup": {"seed": 0, "trainer_name": "static", "train": True,
                      "device": "cpu"},
            "model": model,
            "dataset": {"name": "toy", "metaname": "elliptic_pdes/Poisson-Gauss",
                        "base_path": str(tmp_path), "train_size": 8, "val_size": 2,
                        "test_size": 2, "batch_size": 4},
            "optimizer": {**TINY_OPT, "args": {**TINY_OPT["args"], "epoch": 2,
                                               "eval_every_eps": 1}},
            "path": _paths(tmp_path / side, "toy")}
    jt = JStaticTrainer(cfgs["jax"])
    pt = StaticTrainer(cfgs["torch"])
    assert pt.graphs.encoder_t is None and pt.graphs.decoder_t is None
    load_flax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    jt.fit(verbose=False)
    pt.fit(verbose=False)
    got = np.load(tmp_path / "torch" / "toy_loss.npz")
    want = np.load(tmp_path / "jax" / "toy_loss.npz")
    np.testing.assert_array_equal(got["epochs"], want["epochs"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(got["val_losses"], want["val_losses"], rtol=2e-4)
    np.testing.assert_allclose(pt.datarow["relative error (direct)"],
                               jt.datarow["relative error (direct)"], rtol=1e-3)
    ref = flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params))
    ours = pt.model.state_dict()
    for k, w in ref.items():
        err = np.abs(ours[k].numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max(), (k, err)
    assert pt.step == 2 * len(pt.train_loader)
