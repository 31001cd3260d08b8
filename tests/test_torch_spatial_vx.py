"""Spatial (query) parallelism of the port on vx data (a mesh per sample),
and edge drop under spatial parallelism, on the CPU: two or four ranks over
gloo (``tests/torch_dist.py``), each test starting its ranks once.

- Edge drop at sp 2 on the fx config of ``tests/test_torch_parallel.py``
  (``ratio`` 0.5 and ``max_neighbors`` 3): two steps equal one process's
  (``ops/edge_drop.py::bucket_uniforms`` draws the uncut graph's uniforms,
  of which a rank keeps its rows; their width, ``ops/padding.py::
  bucket_width``, is the uncut layout's widest bucket): the losses within rtol 1e-5, the first
  gradients within 1e-5 of each tensor's largest entry, the weights after
  the steps as ``tests/test_torch_spatial.py`` holds them.
- The vx GAOT (96 nodes a sample padded to 128, an 8x8 grid, two scales with
  scale weights, the statistical embedding) at sp 2 against the JAX
  package's under ``spatial_sharding()`` on a (1, 2) mesh, on bucketed and
  on dense graphs: the forward, the masked loss and every gradient within
  1e-5 of each tensor's largest entry.
- The vx static trainer at sp 2 (without and with ``max_neighbors`` edge
  drop) and at dp 2 x sp 2 (with it, and batches that dp does not divide)
  against one process: two steps' losses, the first gradients, the weights
  after them, the validation loss and the test metric.
- The vx sequential trainer at sp 2 against one process: two steps, the
  validation loss and the rollout's errors in every predict mode.
- The vx graph cache under sp 2: each rank's cut build has a file of its
  own, a second trainer hits it and repeats the losses bit for bit, and a
  one-process run reads none of the ranks' files.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist as td  # noqa: E402
from synthetic import make_sequential_vx_dataset  # noqa: E402
from test_torch_parallel import _close, _config, _vx_config  # noqa: E402

SP2 = {"data_parallel": 1, "model_parallel": 2, "spatial_parallel": True}
ONE = {"data_parallel": -1, "model_parallel": 1, "spatial_parallel": False}


def _one(cfg):
    return dict(cfg, setup=dict(cfg["setup"], **ONE))


def _steps_match(got, want, rel=1e-5):
    """Two ranks' (or four) steps against one process's."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rel)
    _close(got["grads"], want["grads"], rel, "grads")
    _close(got["weights"], want["weights"], rel, "weights", base=None)


DROPS = {"ratio": {"sampling_strategy": "ratio", "sample_ratio": 0.5},
         "max_neighbors": {"sampling_strategy": "max_neighbors", "max_neighbors": 3}}


def test_edge_drop_under_spatial_parallel_matches_one_process(tmp_path):
    """fx, sp 2: each rank draws one process's masks for its rows."""
    cfgs = [_config(tmp_path, f"drop_{k}", setup=SP2, model={"magno": v})
            for k, v in DROPS.items()]
    ranks = td.run_ranks(td.several, 2, tmp_path,
                         [("train_steps", (cfg, None, 2)) for cfg in cfgs])
    for i, cfg in enumerate(cfgs):
        one = td.train_steps(0, 1, _one(cfg), None, 2)
        for r in ranks:
            _steps_match(r[i], one)


# ---------------------------------------------------------------------------

MODEL = {
    "latent_tokens_size": [8, 8],
    "args": {
        "magno": {"coord_dim": 2, "radius": 0.3, "hidden_size": 16, "mlp_layers": 2,
                  "lifting_channels": 8, "scales": [1.0, 1.6],
                  "use_scale_weights": True},
        "transformer": {"patch_size": 2, "hidden_size": 16, "num_layers": 2,
                        "attn_config": {"num_heads": 2, "num_kv_heads": 2}},
    },
}
B, N = 4, 96


def _jax_vx(x, lat, pn, tgt, bucketing: bool):
    """The JAX GAOT on the vx graphs of ``x``, under spatial_sharding on a
    (1, 2) mesh: its weights, forward, masked loss and gradients."""
    import jax
    import jax.numpy as jnp

    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.core.config import ModelConfig, merge_config
    from gaot_tpu.data.graph_builder import GraphBuilder, vx_batch_graphs, vx_graph_buffers
    from gaot_tpu.models import GAOT
    from gaot_tpu.parallel import make_mesh, spatial_sharding
    from gaot_tpu.train.static_trainer import masked_mse

    cfg = merge_config(ModelConfig, MODEL)
    magno = cfg.args.magno
    split = GraphBuilder(morton=True).build_all_vx_graphs(
        {"test": {"x": x}}, lat, magno.radius, magno.scales, build_train=False,
        with_transpose=True, bucketing=bucketing)["test"]
    bufs = vx_graph_buffers(split)
    bufs.pop("node_perm")
    enc, dec, enc_t, dec_t = vx_batch_graphs({k: jnp.asarray(v) for k, v in bufs.items()},
                                             len(magno.scales))
    model = GAOT(input_size=pn.shape[-1], output_size=tgt.shape[-1], config=cfg)
    args = (jnp.asarray(lat), jnp.asarray(split.coords), jnp.asarray(pn), enc, dec)
    kw = dict(encoder_tgraphs=enc_t, decoder_tgraphs=dec_t)
    params = jax.jit(model.init)(jax.random.key(0), *args, **kw)

    def loss_fn(p):
        pred = model.apply(p, *args, **kw)
        return masked_mse(pred, jnp.asarray(tgt), jnp.ones(B, bool),
                          jnp.asarray(split.node_mask)), pred

    with jax.set_mesh(make_mesh(1, 2)), spatial_sharding():
        (loss, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    sd = lambda t: flax_to_torch_state_dict(jax.tree.map(np.asarray, t))
    return sd(params), np.asarray(pred), float(loss), sd(grads), split


def test_vx_model_under_spatial_parallel_matches_jax(tmp_path):
    """The vx GAOT at sp 2, bucketed and dense graphs, against JAX's under
    spatial_sharding, and the ranks' cut graphs hold every row once."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
    ax = np.linspace(-1, 1, 8)
    lat = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    n_pad = 128
    pn = rng.normal(size=(B, n_pad, 3)).astype(np.float32)
    tgt = rng.normal(size=(B, n_pad, 2)).astype(np.float32)
    layouts = {"bucketed": True, "dense": False}
    want, calls = {}, []
    for name, bucketing in layouts.items():
        params, pred, loss, grads, split = _jax_vx(x, lat, pn, tgt, bucketing)
        weights = td.save_weights(params, str(tmp_path / f"w_{name}.pt"))
        want[name] = (pred, loss, grads, split)
        calls.append(("spatial_vx_model", (MODEL, weights, x, lat, pn, tgt, bucketing)))
    ranks = td.run_ranks(td.several, 2, tmp_path, calls)
    for i, name in enumerate(layouts):
        pred, loss, grads, split = want[name]
        for r in ranks:
            got = r[i]
            np.testing.assert_array_equal(got["coords"], split.coords)
            np.testing.assert_array_equal(got["node_mask"], split.node_mask)
            _close({"pred": got["pred"]}, {"pred": pred}, 1e-5, f"{name} forward")
            assert got["loss"] == pytest.approx(loss, rel=1e-5), name
            _close(got["grads"], grads, 1e-5, f"{name} grads vs JAX")


# ---------------------------------------------------------------------------

TRAINER_RUNS = {   # world: (setup, magno overrides of each config, split sizes)
    "sp2": (2, SP2, [None, DROPS["max_neighbors"]], {}),
    # 6 / 3 / 3 samples in batches of 4: the second training batch holds 2
    # samples (rank 0 of the data axis has both, rank 1 none) and the
    # validation and test batches 3, which dp 2 does not divide.
    "dp2xsp2": (4, dict(SP2, data_parallel=2), [DROPS["max_neighbors"]],
                {"train_size": 6, "val_size": 3, "test_size": 3}),
}


@pytest.mark.parametrize("run", sorted(TRAINER_RUNS))
def test_vx_trainer_under_spatial_parallel_matches_one_process(tmp_path, run):
    world, setup, drops, sizes = TRAINER_RUNS[run]
    cfgs = [_vx_config(tmp_path, f"vx{i}", setup=setup,
                       model={"magno": d} if d else None)
            for i, d in enumerate(drops)]
    for cfg in cfgs:
        cfg["dataset"].update(sizes)
    ranks = td.run_ranks(td.several, world, tmp_path,
                         [("steps_and_evaluate", (cfg, None, 2)) for cfg in cfgs])
    for i, cfg in enumerate(cfgs):
        one = td.steps_and_evaluate(0, 1, _one(cfg), None, 2)
        for r in ranks:
            _steps_match(r[i], one)
            assert r[i]["eval"]["val"] == pytest.approx(one["eval"]["val"], rel=1e-5)
            assert r[i]["eval"]["metric"] == pytest.approx(one["eval"]["metric"],
                                                           rel=1e-5)


SEQ_META = "_test/seq_vx_sp"
SEQ_META_KW = dict(periodic=False, group_u="u", group_c="c", group_x="x", type="gaot",
                   domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=False,
                   active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
                   signed={"u": [True], "c": [True]}, names={"u": ["$u$"], "c": ["$c$"]},
                   global_mean=[0.0], global_std=[1.0])


def test_vx_sequential_trainer_under_spatial_parallel_matches_one_process(tmp_path):
    """Two pair steps, the validation loss and the rollout (every predict
    mode; each step's prediction gathered over all the padded nodes before
    the next step's encoder reads them) at sp 2 equal one process's."""
    make_sequential_vx_dataset(str(tmp_path / "seqvx.npz"), num_samples=8)
    cfg = _config(tmp_path, "seqvx", data=False, setup=dict(SP2, trainer_name="sequential"),
                  dataset={"name": "seqvx", "metaname": SEQ_META, "train_size": 4,
                           "val_size": 2, "test_size": 2, "batch_size": 4,
                           "max_time_diff": 14, "time_step": 2, "stepper_mode": "output",
                           "predict_mode": "all", "metric": "final_step"})
    meta = {SEQ_META: SEQ_META_KW}
    ranks = td.run_ranks(td.several, 2, tmp_path,
                         [("steps_and_evaluate", (cfg, None, 2))], meta)
    one = td.several(0, 1, [("steps_and_evaluate", (_one(cfg), None, 2))], meta)[0]
    assert len(one["eval"]["metric"]) == 3
    for r in ranks:
        _steps_match(r[0], one)
        assert r[0]["eval"]["val"] == pytest.approx(one["eval"]["val"], rel=1e-5)
        for mode, err in one["eval"]["metric"].items():
            assert r[0]["eval"]["metric"][mode] == pytest.approx(err, rel=1e-5), mode


def test_vx_graph_cache_under_spatial_parallel(tmp_path):
    """Each rank writes its own cut build; a second trainer hits it with the
    same losses bit for bit; one process builds and writes the full graphs,
    reading no rank's file."""
    cfg = _vx_config(tmp_path, "vxc", setup=SP2, model={"magno": DROPS["max_neighbors"]})
    cache = tmp_path / "cache"
    cfg["dataset"]["graph_cache_dir"] = str(cache)
    ranks = td.run_ranks(td.cache_runs, 2, tmp_path, cfg, 2)
    for first, second in ranks:
        assert not first["hit"] and second["hit"]
        assert first["losses"] == second["losses"]
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
    files = sorted(cache.glob("*.npz"))
    assert len(files) == 2
    one = td.cache_runs(0, 1, _one(cfg), 2)
    assert [run["hit"] for run in one] == [False, True]
    assert len(list(cache.glob("*.npz"))) == 3
    np.testing.assert_allclose(one[0]["losses"], ranks[0][0]["losses"], rtol=1e-5)
    assert one[0]["losses"] == one[1]["losses"]


@pytest.mark.parametrize("stacked", [False, True], ids=["fx", "vx"])
def test_draw_width_is_the_widest_bucket(stacked):
    """``bucket_width`` (the width of edge drop's draw that a rank takes
    from the uncut graph) equals the widest bucket that the bucketizer makes
    of the graph, or its K where the graph stays dense."""
    from gaot_torch.ops.neighbor_search import radius_search
    from gaot_torch.ops.padding import (
        bucket_width,
        bucketize_graph,
        bucketize_graphs_stacked,
        pad_csr,
        stack_graphs,
    )

    rng = np.random.default_rng(0)
    ax = np.linspace(-1, 1, 16)
    lat = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
    graphs = [pad_csr(*radius_search(rng.uniform(-1, 0.6, (800, 2)), lat, r))
              for r in (0.12, 0.3)]
    if stacked:
        graphs = [stack_graphs([g, pad_csr(*radius_search(
            rng.uniform(-1, 1, (800, 2)), lat, r))]) for g, r in zip(graphs, (0.12, 0.3))]
    bucketize = bucketize_graphs_stacked if stacked else bucketize_graph
    widths = []
    for g in graphs:
        bg = bucketize(g, 800, with_transpose=False)
        want = g.k if bg is None else max(b.indices.shape[-1] for b in bg.buckets)
        assert bucket_width(g) == want
        widths.append((bg is not None, want < g.k))
    assert any(bucketed for bucketed, _ in widths)
    if not stacked:
        assert (True, True) in widths   # a bucketed graph narrower than its K
