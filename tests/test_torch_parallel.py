"""Multi-GPU training of the port (``gaot_torch/parallel/``) on the CPU: two
ranks over gloo (``tests/torch_dist.py``: spawned processes, a ``file://``
store, a timeout per child), held against the JAX package's mesh on the
conftest's 8 virtual devices and against one process of the port.

- ``param_specs`` equal to JAX's for the same weights (names through
  ``mapping_entries``);
- a dp = 2 step equal to JAX's (2, 1) mesh step: the loss, every gradient
  after DDP, the weights after two AdamW steps;
- the global masked mean with ranks of unequal valid counts (vx node
  masks, a padded last batch) equal to one process, where the mean of the
  ranks' means is not;
- edge drop (fx and vx) and attention dropout under dp = 2, and attention
  dropout under mp = 2, equal to one process with the same draws;
- mp = 2 (tensor parallelism) forward and gradients equal to JAX's (1, 2)
  mesh, and a TP checkpoint loading into one process;
- a vx rank's flattened graphs equal to its slice of the one-process
  layout; vx and sequential fits, and a 2-rank fit through the CLI, equal
  to one process, with only rank 0 writing.

Tolerances, fp32: the port against JAX within 1e-5 of each tensor's
largest entry (gradients also rtol 1e-4: fp32 sums in another order) and
the loss within 1e-6 relative; two ranks against one process of the port
within 1e-6 of each tensor's largest entry (the same arithmetic but the
data-parallel sums; 1e-5 where tensor parallelism under attention dropout
moves the query projections' cancelling sums). Weights after AdamW steps
are also allowed 10× that of their largest update (``_close``).
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist as td  # noqa: E402
from synthetic import make_static_fx_dataset, make_static_vx_dataset  # noqa: E402
from test_train_e2e import TINY_MODEL, TINY_OPT, _paths  # noqa: E402


def _config(tmp_path, name, setup=None, dataset=None, model=None, data=True):
    if data:
        make_static_fx_dataset(str(tmp_path / f"{name}.npz"))
    s = {"seed": 0, "trainer_name": "static", "train": True, "device": "cpu"}
    s.update(setup or {})
    d = {"name": name, "metaname": "elliptic_pdes/Poisson-Gauss",
         "base_path": str(tmp_path), "train_size": 8, "val_size": 3,
         "test_size": 3, "batch_size": 4}
    d.update(dataset or {})
    m = copy.deepcopy(TINY_MODEL)
    for k, v in (model or {}).items():
        m["args"][k].update(v)
    return {"setup": s, "model": m, "dataset": d,
            "optimizer": copy.deepcopy(TINY_OPT), "path": _paths(tmp_path, name)}


def _close(got, want, rel, what="", base=None):
    """Every tensor of ``want`` (name → array) within ``rel`` of its
    largest entry; with ``base`` (the weights before some optimizer steps)
    also 10·``rel`` of its largest update: AdamW divides each gradient by
    its running scale, so an update carries the gradient's relative
    rounding, which a tensor updated from zero shows against its own size."""
    assert set(got) == set(want), what
    for k in sorted(want):
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64).reshape(w.shape)
        err = np.abs(g - w).max()
        bound = rel * np.abs(w).max()
        if base is not None:
            bound += 10 * rel * np.abs(w - np.asarray(base[k], np.float64)).max()
        assert err <= max(bound, 1e-30), (what, k, err, np.abs(w).max())


def _jax_trainer(cfg):
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    cfg = copy.deepcopy(cfg)
    cfg["setup"].pop("device", None)
    return JStaticTrainer(cfg)


def _jax_weights(jt, tmp_path, name="w.pt"):
    import jax

    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict

    return td.save_weights(flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params)),
                           str(tmp_path / name))


def _jax_step(jt, steps: int = 2):
    """JAX's mesh: (loss, gradients by torch name) of the first batch, then
    the weights after ``steps`` of its own training steps."""
    import jax

    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.train.static_trainer import masked_mse

    jt._build_steps()
    batches = [b for _, b in zip(range(steps), iter(jt.train_loader))]
    placed = jt.place_batch_once(batches[0])
    coord, pndata, target, sm, nm, enc, dec, enc_t, dec_t = jt._step_args(placed)
    key = jax.random.key(0)

    def loss_fn(p):
        pred = jt.model.apply(p, jt.latent_tokens_coord, coord, pndata, enc, dec,
                              training=True, rngs={"dropout": key, "edge_drop": key},
                              encoder_tgraphs=enc_t, decoder_tgraphs=dec_t)
        return masked_mse(pred, target, sm, nm)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jt.params)
    losses = [float(jt.train_step(b)) for b in batches]
    to_sd = lambda t: flax_to_torch_state_dict(jax.tree.map(np.asarray, t))
    return float(loss), to_sd(grads), to_sd(jt.params), losses


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [2, 3, 4])
def test_param_specs_match_jax(mp, monkeypatch):
    """The port's split dims equal JAX's PartitionSpecs through the weight
    map: P(None, "model") on a kernel [in, out] splits a torch weight's
    dim 0, P("model", None) its dim 1; a dimension mp does not divide stays
    whole in both (JAX's shard_params)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gaot_torch.parallel import param_specs
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, mapping_entries
    from gaot_tpu.parallel import param_specs as jparam_specs
    from test_spatial import _build_model

    # The weights' shapes are all the rules read: no initialisation runs.
    from gaot_tpu.models import GAOT as JGAOT

    init = JGAOT.init
    monkeypatch.setattr(JGAOT, "init",
                        lambda self, *a: jax.eval_shape(lambda: init(self, *a)))
    params = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), _build_model()[1])
    jspecs = jparam_specs(params, model_parallel=True)
    want = {}
    for path, name, kind in mapping_entries(params):
        sub = params["params"]
        ssub = jspecs["params"]
        for k in path:
            sub, ssub = sub[k], ssub[k]
        if kind != "linear" or ssub["kernel"] == P():
            continue
        axis = list(ssub["kernel"]).index("model")         # flax [in, out]
        if sub["kernel"].shape[axis] % mp == 0:
            want[f"{name}.weight"] = 1 - axis               # torch [out, in]
    # (At mp 3 no width of this model divides: every weight stays whole.)
    assert bool(want) == (mp != 3)
    shapes = {k: v.shape for k, v in flax_to_torch_state_dict(params).items()}
    assert param_specs(shapes, mp) == want
    assert param_specs(shapes, 1) == {}


def test_data_parallel_step_matches_jax_mesh(tmp_path):
    """dp = 2: the loss, every gradient after DDP and the weights after two
    AdamW steps equal JAX's (2, 1) mesh and one process of the port."""
    cfg = _config(tmp_path, "dp", setup={"data_parallel": 2})
    jt = _jax_trainer(cfg)
    assert dict(jt.mesh.shape) == {"data": 2, "model": 1}
    weights = _jax_weights(jt, tmp_path)
    want_loss, want_grads, want_w, want_losses = _jax_step(jt)

    ranks = td.run_ranks(td.train_steps, 2, tmp_path, cfg, weights, 2)
    one = td.train_steps(0, 1, dict(cfg, setup=dict(cfg["setup"], data_parallel=-1)),
                         weights, 2)
    w0 = torch.load(weights)
    for r in ranks:
        assert r["losses"][0] == pytest.approx(want_loss, rel=1e-6)
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-6)
        _close(r["grads"], want_grads, 1e-5, "grads vs JAX")
        _close(r["weights"], want_w, 1e-5, "weights vs JAX", base=w0)
        _close(r["grads"], one["grads"], 1e-6, "grads vs one process")
        _close(r["weights"], one["weights"], 1e-6, "weights vs one process", base=w0)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-6)


@pytest.mark.parametrize("case", ["vx_node_masks", "padded_last_batch"])
def test_global_masked_mean_with_unequal_counts(tmp_path, case):
    """Two ranks whose valid counts differ: the loss and the gradient of the
    prediction equal one process's masked MSE; the mean of the ranks' own
    means does not."""
    from gaot_torch.train.static_trainer import masked_mse

    rng = np.random.default_rng(0)
    if case == "vx_node_masks":
        b, n = 4, 10
        sample_mask = np.ones(b, bool)
        # rank 0's samples keep 9 and 8 nodes, rank 1's 2 and 1
        node_mask = np.arange(n)[None, :] < np.array([9, 8, 2, 1])[:, None]
    else:
        # a last batch of 3 real samples in 4 slots, and a batch of 3 that
        # two ranks split as 2 + 2 (one wrapped-around, masked)
        b, n = 3, 10
        sample_mask = np.ones(b, bool)
        node_mask = None
    pred = rng.normal(size=(b, n, 2)).astype(np.float32)
    target = rng.normal(size=(b, n, 2)).astype(np.float32)
    ranks = td.run_ranks(td.masked_means, 2, tmp_path, pred, target, sample_mask,
                         node_mask)
    p = torch.from_numpy(pred).requires_grad_()
    want = masked_mse(p, torch.from_numpy(target), torch.from_numpy(sample_mask),
                      None if node_mask is None else torch.from_numpy(node_mask))
    want.backward()
    want = want.detach()
    for loss, grad, own in ranks:
        assert loss == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(grad, p.grad.numpy(), rtol=1e-6, atol=1e-9)
        assert abs(own - float(want)) > 1e-2 * float(want)
    if case == "padded_last_batch":
        sample_mask = np.array([True, True, True, False])
        pred, target = np.concatenate([pred, pred[:1]]), np.concatenate([target, target[:1]])
        ranks = td.run_ranks(td.masked_means, 2, tmp_path, pred, target, sample_mask, None)
        for loss, grad, own in ranks:
            assert loss == pytest.approx(float(want), rel=1e-6)
            np.testing.assert_allclose(grad[:3], p.grad.numpy(), rtol=1e-6, atol=1e-9)
            assert not grad[3].any()


def _vx_config(tmp_path, name, **kw):
    make_static_vx_dataset(str(tmp_path / f"{name}.npz"))
    cfg = _config(tmp_path, name, data=False, **kw)
    cfg["dataset"].update(metaname="compressible_flow/naca0012", val_size=2,
                          test_size=2)
    return cfg


_DROPOUT = {"magno": {"sampling_strategy": "ratio", "sample_ratio": 0.5},
            "transformer": {"attn_config": {"num_heads": 2, "num_kv_heads": 2,
                                            "atten_dropout": 0.2}}}
DRAWS = {
    # fx: one edge-drop mask for the batch, then attention dropout per sample
    "fx_edge_drop_attn_dropout": dict(model=_DROPOUT),
    # vx: the masks of each sample's rows (degree-bucketed graphs)
    "vx_edge_drop": dict(vx=True, model={
        "magno": {"sampling_strategy": "max_neighbors", "max_neighbors": 3}}),
    # tensor parallelism: each rank keeps its heads of the dropout mask (the
    # query projections' gradients, sums that cancel, within 1e-5)
    "tp_attn_dropout": dict(model=_DROPOUT, rel=1e-5,
                            setup={"data_parallel": 1, "model_parallel": 2}),
}


@pytest.mark.parametrize("case", sorted(DRAWS))
def test_draws_under_data_parallel_match_one_process(tmp_path, case):
    """Edge drop and attention dropout at dp = 2 (and attention dropout at
    mp = 2) draw what one process draws for the global batch: two steps'
    losses, the first gradients and the weights after them equal one
    process's."""
    kw = dict(DRAWS[case])
    vx = kw.pop("vx", False)
    setup = kw.pop("setup", {"data_parallel": 2})
    rel = kw.pop("rel", 1e-6)
    cfg = (_vx_config if vx else _config)(tmp_path, "draws", setup=setup, **kw)
    ranks = td.run_ranks(td.train_steps, 2, tmp_path, cfg, None, 2)
    one = td.train_steps(0, 1, dict(cfg, setup=dict(cfg["setup"], data_parallel=-1,
                                                    model_parallel=1)), None, 2)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-6)
        _close(r["grads"], one["grads"], rel, "grads")
    # the draws matter: without them the step differs
    cfg_off = copy.deepcopy(cfg)
    cfg_off["model"]["args"]["magno"]["sampling_strategy"] = None
    cfg_off["model"]["args"]["transformer"]["attn_config"]["atten_dropout"] = 0.0
    off = td.train_steps(0, 1, dict(cfg_off, setup=dict(cfg["setup"], data_parallel=-1,
                                                         model_parallel=1)), None, 1)
    assert off["losses"][0] != pytest.approx(one["losses"][0], rel=1e-4)


def test_vx_data_parallel_matches_one_process(tmp_path):
    """A vx trainer at dp = 2: each rank's flattened graphs are its slice of
    the one-process batch's (ids offset by the rank's first sample), and
    two steps, the validation loss and the test metric (splits of 2
    samples, one per rank) equal one process's."""
    cfg = _vx_config(tmp_path, "vx", setup={"data_parallel": 2})
    cfg1 = dict(cfg, setup=dict(cfg["setup"], data_parallel=-1))
    ranks = td.run_ranks(td.steps_and_evaluate, 2, tmp_path, cfg, None, 2, True)
    one = td.steps_and_evaluate(0, 1, cfg1, None, 2, True)
    whole = one["flat"]
    bl = whole["samples"] // 2
    for r, got in enumerate(ranks):
        share = got["flat"]
        np.testing.assert_array_equal(share["x"], whole["x"][r * bl:(r + 1) * bl])
        for side in ("enc", "dec"):
            offset = r * bl * whole["sources"][side]   # the rank's first source
            for g, w in zip(share[side], whole[side]):
                assert g["samples"] == bl and g["rows"] == w["rows"]
                for gi, wi, gm, wm in zip(g["idx"], w["idx"], g["mask"], w["mask"]):
                    rows = gi.shape[0]
                    assert rows * 2 == wi.shape[0]
                    sl = slice(r * rows, (r + 1) * rows)
                    np.testing.assert_array_equal(gi, wi[sl] - offset)
                    np.testing.assert_array_equal(gm, wm[sl])
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
        _close(got["grads"], one["grads"], 1e-6, "grads")
        assert got["eval"]["val"] == pytest.approx(one["eval"]["val"], rel=1e-6)
        assert got["eval"]["metric"] == pytest.approx(one["eval"]["metric"], rel=1e-6)


def test_tensor_parallel_matches_jax_mesh(tmp_path):
    """mp = 2: each rank holds half the heads and SwiGLU columns; the loss
    (the forward), every gradient and the weights after two AdamW steps
    equal JAX's (1, 2) mesh (tensor-sharded params) and one process; the
    validation loss and test metric (3 samples, padded) equal one process's."""
    cfg = _config(tmp_path, "tp", setup={"data_parallel": 1, "model_parallel": 2})
    jt = _jax_trainer(cfg)
    assert dict(jt.mesh.shape) == {"data": 1, "model": 2}
    weights = _jax_weights(jt, tmp_path)
    want_loss, want_grads, want_w, want_losses = _jax_step(jt)
    ranks = td.run_ranks(td.steps_and_evaluate, 2, tmp_path, cfg, weights, 2)
    cfg1 = dict(cfg, setup=dict(cfg["setup"], model_parallel=1))
    one = td.steps_and_evaluate(0, 1, cfg1, weights, 2)
    w0 = torch.load(weights)
    for r in ranks:
        assert sorted(r["specs"]) == sorted(
            k for k in w0 if ".attn." in k and "proj" in k or ".ffn.w" in k)
        for k, dim in r["specs"].items():
            assert r["local_shapes"][k][dim] * 2 == w0[k].shape[dim]
        assert r["losses"][0] == pytest.approx(want_loss, rel=1e-6)
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-6)
        _close(r["grads"], want_grads, 1e-5, "grads vs JAX")
        _close(r["weights"], want_w, 1e-5, "weights vs JAX", base=w0)
        _close(r["grads"], one["grads"], 1e-6, "grads vs one process")
        _close(r["weights"], one["weights"], 1e-6, "weights vs one process", base=w0)
        assert r["eval"]["val"] == pytest.approx(one["eval"]["val"], rel=1e-6)
        assert r["eval"]["metric"] == pytest.approx(one["eval"]["metric"], rel=1e-6)


def _write(tmp_path, cfg, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("trainer", ["static", "sequential", "sequential_sp"])
def test_cli_fit_two_ranks_matches_one(tmp_path, trainer):
    """A dp = 2 fit through ``gaot_torch.cli`` (validation, checkpoint,
    test: the sequential one by rollout, each step's nodes gathered under
    spatial parallelism) equals the one-process fit's losses within 1e-5
    and its metric; rank 0 alone writes the CSV row, the loss record and
    the checkpoint."""
    from gaot_torch import cli
    from synthetic import make_sequential_fx_dataset

    kw = {}
    if trainer.startswith("sequential"):
        make_sequential_fx_dataset(str(tmp_path / "seq.npz"), num_samples=12)
        kw = dict(data=False, setup={"trainer_name": "sequential"},
                  dataset={"name": "seq", "metaname": "incompressible_fluids/NS-Gauss",
                           "train_size": 4, "val_size": 2, "test_size": 2,
                           "batch_size": 8})
    cfgs = {}
    for run in ("one", "two"):
        cfg = _config(tmp_path, run, **copy.deepcopy(kw))
        cfg["optimizer"]["args"]["epoch"] = 2
        cfg["optimizer"]["args"]["eval_every_eps"] = 1
        cfg["path"] = _paths(tmp_path / run, run)
        cfgs[run] = cfg
    cfgs["two"]["setup"].update(distributed=True, data_parallel=2)
    if trainer == "sequential_sp":
        cfgs["two"]["setup"].update(data_parallel=1, model_parallel=2,
                                    spatial_parallel=True)
    assert cli.main(["-c", _write(tmp_path, cfgs["one"], "one")]) == 0
    rows = td.run_ranks(td.fit_cli, 2, tmp_path, _write(tmp_path, cfgs["two"], "two"))
    one = np.load(tmp_path / "one" / "one_loss.npz")
    two = np.load(tmp_path / "two" / "two_loss.npz")
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(two["val_losses"], one["val_losses"], rtol=1e-5)
    with open(tmp_path / "one" / "one_db.csv") as f:
        want = list(__import__("csv").DictReader(f))
    with open(tmp_path / "two" / "two_db.csv") as f:
        got = list(__import__("csv").DictReader(f))
    assert len(got) == len(want) == 1
    metric = [k for k in want[0] if k.startswith("relative error") and want[0][k]]
    assert metric
    for k in metric:
        assert float(got[0][k]) == pytest.approx(float(want[0][k]), rel=1e-5)
    assert rows[0]["row"]["nparams"] == rows[1]["row"]["nparams"] == int(want[0]["nparams"])
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == sorted(
        p.name.replace("one", "two") for p in (tmp_path / "one").iterdir())


def test_tp_checkpoint_loads_into_one_process(tmp_path):
    """A checkpoint written by an mp = 2 fit holds the full weights: it
    loads strictly into one process, and one process's into mp = 2 ranks."""
    from gaot_torch.train import StaticTrainer

    cfg = _config(tmp_path, "ckpt", setup={"data_parallel": 1, "model_parallel": 2,
                                           "distributed": True})
    cfg["optimizer"]["args"]["epoch"] = 1
    cfg["optimizer"]["args"]["eval_every_eps"] = 1
    cfg1 = dict(cfg, setup=dict(cfg["setup"], distributed=False, model_parallel=1))
    # one process's checkpoint (update count 5), for the ranks to load
    other = dict(cfg, path=_paths(tmp_path / "one", "one"))
    one = StaticTrainer(dict(other, setup=cfg1["setup"]))
    one.step = 5
    one.save_ckpt()
    ranks = td.run_ranks(td.fit_cli, 2, tmp_path, _write(tmp_path, cfg, "ckpt"), other)
    for r in ranks:
        assert r["loaded"]["step"] == 5
        for k, v in one.model.state_dict().items():
            assert torch.equal(r["loaded"]["weights"][k], v), k
    fresh = StaticTrainer(cfg1)
    fresh.load_ckpt()                               # strict
    assert fresh.step == 2
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(ranks[0]["weights"][k], v), k


@pytest.mark.parametrize("samples", [None, 2, 4])
def test_batch_share_draws_the_global_batchs_rows(samples):
    """A BatchShare draws the global batch's numbers and keeps the caller's
    samples' rows (all of them where the tensor has no sample axis or holds
    the whole batch), and its generator moves as one process's."""
    from gaot_torch.ops.draws import BatchShare, uniform

    shape, total, offset = (6, 5), 4, 2
    gen, ref = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    got = uniform(shape, BatchShare(gen, offset, total), "cpu", samples)
    if samples in (None, total):
        want = torch.rand(shape, generator=ref)
    else:
        per = shape[0] // samples
        want = torch.rand((per * total, 5), generator=ref)[per * offset:per * offset + 6]
    assert torch.equal(got, want)
    assert torch.equal(torch.rand(3, generator=gen), torch.rand(3, generator=ref))
