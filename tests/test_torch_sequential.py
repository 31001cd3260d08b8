"""The port's sequential data pipeline, conditional norm and rollout against
the JAX package on the CPU (fp32, inputs from NumPy seeds, JAX weights
carried over with a strict load).

- Pipeline, bit for bit: ``generate_time_pairs``,
  ``compute_sequential_stats``, ``SequentialDataProcessor`` (its splits,
  statistics and times: an fx file with coordinates, a Poseidon-named
  file without them, cut by ``use_sparse`` or not, and a vx file), the
  host ``get_batch`` of ``DynamicPairBatcher`` in the three stepper modes
  (fx, and vx with its graph buffers, the batch holding one sample under
  two pairs) and of ``RolloutTestBatcher`` in the three predict modes.
- The device route (``DynamicPairBatcher.device_get_batch`` on CPU
  tensors) against JAX's ``device_parts`` under ``jax.jit``: within 1e-6
  relative (both fp32; the rows and the graph buffers exactly).
- ``predict_mode_indices`` in the three modes at t = 14 and shorter.
- ``ConditionedNorm`` alone and a conditional-norm GAOT (the torch_parity
  workload): the forward at rtol 1e-4 / atol 1e-5 and every gradient
  within rtol 1e-4 / atol 1e-5 of its tensor's largest entry, against
  ``jax.grad``.

The rollout is held in ``tests/test_torch_seq_rollout.py``, the trainer in
``tests/test_torch_seq_trainer.py`` and its neighbours.
"""
import contextlib
import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402
from synthetic import make_sequential_fx_dataset, make_sequential_vx_dataset  # noqa: E402

STEPPERS = ("output", "residual", "time_der")
PREDICT = ("autoregressive", "direct", "star")
VX_META = "_test/seq_vx_toy"


def _assert_equal(a, b, path="value"):
    """Nested dicts of arrays and scalars, equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys() ^ b.keys())
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


@contextlib.contextmanager
def vx_metadata():
    """The metadata of tests/test_train_e2e.py's vx sequential case,
    registered in both packages' registries for the block."""
    from gaot_torch.core import metadata as tmeta
    from gaot_tpu.core import metadata as jmeta

    kw = dict(periodic=False, group_u="u", group_c="c", group_x="x", type="gaot",
              domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=False,
              active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
              signed={"u": [True], "c": [True]}, names={"u": ["$u$"], "c": ["$c$"]},
              global_mean=[0.0], global_std=[1.0])
    tmeta.DATASET_METADATA[VX_META] = tmeta.Metadata(**kw)
    jmeta.DATASET_METADATA[VX_META] = jmeta.Metadata(**kw)
    try:
        yield
    finally:
        del tmeta.DATASET_METADATA[VX_META], jmeta.DATASET_METADATA[VX_META]


def _processors(cfg_dict):
    """Both packages' SequentialDataProcessors of one dataset config, run."""
    from gaot_torch.core.config import DatasetConfig, merge_config
    from gaot_torch.core.metadata import DATASET_METADATA
    from gaot_torch.data.sequential import SequentialDataProcessor
    from gaot_tpu.core.config import DatasetConfig as JDatasetConfig
    from gaot_tpu.core.config import merge_config as jmerge
    from gaot_tpu.core.metadata import DATASET_METADATA as JMETA
    from gaot_tpu.data.sequential import SequentialDataProcessor as JProcessor

    tcfg, jcfg = merge_config(DatasetConfig, cfg_dict), jmerge(JDatasetConfig, cfg_dict)
    tp_, jp = (SequentialDataProcessor(tcfg, DATASET_METADATA[tcfg.metaname]),
               JProcessor(jcfg, JMETA[jcfg.metaname]))
    return tp_, tp_.load_and_process_data(), jp, jp.load_and_process_data()


def test_time_pairs_and_stats_bitwise():
    from gaot_torch.data.sequential import compute_sequential_stats, generate_time_pairs
    from gaot_tpu.data import sequential as js

    for t, step in ((14, 2), (10, 2), (7, 1), (14, 3), (1, 2)):
        _assert_equal(dict(zip("io", generate_time_pairs(t, step))),
                      dict(zip("io", js.generate_time_pairs(t, step))))
    assert len(generate_time_pairs(14, 2)[0]) == 28
    rng = np.random.default_rng(0)
    u = rng.normal(size=(6, 15, 40, 2)).astype(np.float32)
    c = rng.normal(size=(6, 15, 40, 3)).astype(np.float32)
    t = np.linspace(0, 1, 15)
    for kw in (dict(), dict(max_time_diff=10, time_step=2, sample_rate=0.1),
               dict(use_time_norm=False, sample_rate=0.5), dict(max_time_diff=20)):
        _assert_equal(compute_sequential_stats(u, c, t, **kw),
                      js.compute_sequential_stats(u, c, t, **kw))
    _assert_equal(compute_sequential_stats(u, None, t), js.compute_sequential_stats(u, None, t))


def _write_poseidon(path, nodes, steps=17, samples=6, seed=1):
    """u [S, T, N, 2] without coordinates (the processor makes the grid)."""
    u = np.random.default_rng(seed).normal(size=(samples, steps, nodes, 2))
    np.savez(path, u=u.astype(np.float32))


@pytest.mark.parametrize("case", ["fx", "poseidon_grid", "poseidon_sparse", "vx"])
def test_processor_splits_bitwise(tmp_path, case):
    ds = {"base_path": str(tmp_path), "train_size": 3, "val_size": 1, "test_size": 2,
          "max_time_diff": 10, "sample_rate": 0.5}
    if case == "fx":
        make_sequential_fx_dataset(str(tmp_path / "ns_toy.npz"))
        ds.update(name="ns_toy", metaname="incompressible_fluids/NS-Gauss",
                  rand_dataset=True)
    elif case == "vx":
        make_sequential_vx_dataset(str(tmp_path / "seq_vx_toy.npz"))
        ds.update(name="seq_vx_toy", metaname=VX_META)
    else:
        # 97 x 97 = 9409 nodes: the Poseidon use_sparse cut keeps 9216.
        _write_poseidon(str(tmp_path / "NS-Gauss.npz"), 97 * 97)
        ds.update(name="NS-Gauss", metaname="incompressible_fluids/NS-Gauss",
                  use_sparse=case == "poseidon_sparse", max_time_diff=14)
    with vx_metadata():
        tproc, (tsplits, tvx), jproc, (jsplits, jvx) = _processors(ds)
    assert tvx == jvx == (case == "vx")
    _assert_equal(tsplits, jsplits)
    _assert_equal(tproc.stats, jproc.stats)
    np.testing.assert_array_equal(tproc.t_values, jproc.t_values)
    want_t = 15 if case.startswith("poseidon") else 11
    assert tsplits["train"]["u"].shape[1] == want_t
    if case.startswith("poseidon"):
        want_n = 9216 if case == "poseidon_sparse" else 97 * 97
        assert tsplits["test"]["u"].shape[2] == tsplits["test"]["x"].shape[0] == want_n


def _vx_graphs(pkg, splits):
    import importlib

    gb = importlib.import_module(f"{pkg}.data.graph_builder")
    lat = tp_lattice(6)
    return gb.GraphBuilder(morton=True).build_all_vx_graphs(
        {k: {"x": v["x"][:, 0]} for k, v in splits.items()}, lat, 0.35, [1.0],
        with_transpose=True, bucketing=True)


def tp_lattice(n):
    ax = np.linspace(-1, 1, n)
    return np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _data(case):
    """(port splits, JAX splits, stats, port graphs, JAX graphs) of a small
    fx (no c) or vx (with c) dataset, from the JAX processor."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        ds = {"base_path": d, "train_size": 4, "val_size": 1, "test_size": 3,
              "sample_rate": 0.5}
        if case == "fx":
            make_sequential_fx_dataset(os.path.join(d, "ns_toy.npz"), num_samples=8)
            ds.update(name="ns_toy", metaname="incompressible_fluids/NS-Gauss")
        else:
            make_sequential_vx_dataset(os.path.join(d, "seq_vx_toy.npz"), num_samples=8)
            ds.update(name="seq_vx_toy", metaname=VX_META)
        with vx_metadata():
            _, (splits, _), jproc, _ = _processors(ds)
    graphs = (_vx_graphs("gaot_torch", splits), _vx_graphs("gaot_tpu", splits)) \
        if case == "vx" else (None, None)
    return splits, jproc.stats, graphs


def _batchers(case, stepper, split="train"):
    from gaot_torch.data.sequential import DynamicPairBatcher
    from gaot_tpu.data.sequential import DynamicPairBatcher as JBatcher

    splits, stats, (tg, jg) = _data(case)
    sp = splits[split]
    args = (sp["u"], sp["c"], sp["t"], 14, 2, stepper, stats)
    return (DynamicPairBatcher(*args, graphs=tg and tg[split]),
            JBatcher(*args, graphs=jg and jg[split]))


# Sample 1 under pairs 0 and 5 (items 28 + 0, 28 + 5), sample 3 twice.
ITEMS = np.array([28, 33, 3 * 28 + 27, 2, 3 * 28 + 4, 57])


@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("case", ["fx", "vx"])
def test_pair_batches_host_bitwise(case, stepper):
    tb, jb = _batchers(case, stepper)
    assert len(tb) == len(jb) == 4 * 28
    got, want = tb.get_batch(ITEMS), jb.get_batch(ITEMS)
    assert "node_perm" not in got
    _assert_equal(got, want)
    if case == "vx":
        # Each slot carries its own sample's graphs: slots 0 and 1 hold
        # sample 1 under two pairs.
        np.testing.assert_array_equal(got["x"][0], got["x"][1])
        assert got["input"].shape[-1] == 1 + 1 + 2


@pytest.mark.parametrize("mode", PREDICT)
@pytest.mark.parametrize("case", ["fx", "vx"])
def test_rollout_batches_bitwise(case, mode):
    from gaot_torch.data.sequential import RolloutTestBatcher
    from gaot_torch.train import predict_mode_indices
    from gaot_tpu.data.sequential import RolloutTestBatcher as JBatcher

    splits, stats, (tg, jg) = _data(case)
    te = splits["test"]
    ti = predict_mode_indices(mode, 14, 2)
    tb = RolloutTestBatcher(te["u"], te["c"], ti, stats, graphs=tg and tg["test"])
    jb = JBatcher(te["u"], te["c"], ti, stats, graphs=jg and jg["test"])
    idx = np.array([2, 0, 2])
    got = tb.get_batch(idx)
    want = {k: v for k, v in jb.get_batch(idx).items() if k != "node_perm"}
    _assert_equal(got, want)
    assert got["target"].shape[1] == len(ti) - 1


@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("case", ["fx", "vx"])
def test_pair_batches_device_route(case, stepper):
    """The device route on CPU tensors against JAX's device_parts under
    jax.jit, over two batches: inputs and targets within 1e-6 relative
    (both fp32, the same operations), the graph buffers exactly."""
    from gaot_torch.data.sequential import make_sequential_loader

    tb, jb = _batchers(case, stepper)
    get = tb.device_get_batch("cpu")
    dev, assemble = jb.device_parts()
    assemble = jax.jit(assemble)
    for items in (ITEMS, np.array([111, 0, 56, 57, 27, 84])):
        got = {k: v.numpy() for k, v in get(items).items()}
        # node_perm is a record of the graph build, not a batch input.
        want = {k: np.asarray(v) for k, v in
                assemble(dev, jnp.asarray(items, jnp.int32)).items() if k != "node_perm"}
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if k in ("input", "target"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-6 * np.abs(want[k]).max(), err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loader = make_sequential_loader(tb, 4, device="cpu")
    assert loader.row_selects == (1 if case == "fx" else 2 + len(tb.buffers))
    assert len(loader) == 28


@pytest.mark.parametrize("t", [14, 12, 10, 7, 2])
def test_predict_mode_indices(t):
    from gaot_torch.train import predict_mode_indices
    from gaot_tpu.train.sequential_trainer import predict_mode_indices as jidx

    for mode in PREDICT:
        np.testing.assert_array_equal(predict_mode_indices(mode, t, 2), jidx(mode, t, 2))
    if t == 14:   # the reference's hard-coded indices
        np.testing.assert_array_equal(predict_mode_indices("autoregressive", 14, 2),
                                      np.arange(0, 15, 2))
        np.testing.assert_array_equal(predict_mode_indices("direct", 14, 2), [0, 14])
        np.testing.assert_array_equal(predict_mode_indices("star", 14, 2),
                                      [0, 4, 8, 12, 14])


def _grads_close(got, want):
    assert set(got) == set(want)
    for n in sorted(want):
        w = np.asarray(want[n]).reshape(got[n].shape)
        np.testing.assert_allclose(got[n], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=n)


def test_conditioned_norm_matches_jax():
    """x·(1 + c·S(c)) + c·B(c): the forward and the gradients of x, c and
    the four parameters."""
    from gaot_torch.models.mlp import ConditionedNorm
    from gaot_tpu.models.mlp import ConditionedNorm as JNorm

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 6)).astype(np.float32)
    c = rng.normal(size=(3, 1)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jm = JNorm(6)
    params = jm.init(jax.random.key(0), jnp.asarray(c), jnp.asarray(x))
    # normal(0.01) weights start the correction near the identity: a wider
    # draw, so that the test sees the products.
    params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
                          params)

    def loss(p, xx, cc):
        out = jm.apply(p, cc, xx)
        return (out * w).sum(), out

    (_, want), jg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(c))
    m = ConditionedNorm(6)
    p = params["params"]
    with torch.no_grad():
        for name in ("mlp_scale", "mlp_bias"):
            lin = getattr(m, name).layers[0]
            lin.weight.copy_(torch.from_numpy(np.asarray(p[name]["Dense_0"]["kernel"]).T))
            lin.bias.copy_(torch.from_numpy(np.asarray(p[name]["Dense_0"]["bias"])))
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(c).requires_grad_()
    out = m(ct, xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    got = {"x": xt.grad.numpy(), "c": ct.grad.numpy()}
    ref = {"x": jg[1], "c": jg[2]}
    for name in ("mlp_scale", "mlp_bias"):
        lin = getattr(m, name).layers[0]
        got[f"{name}.weight"] = lin.weight.grad.numpy()
        got[f"{name}.bias"] = lin.bias.grad.numpy()
        ref[f"{name}.weight"] = np.asarray(jg[0]["params"][name]["Dense_0"]["kernel"]).T
        ref[f"{name}.bias"] = jg[0]["params"][name]["Dense_0"]["bias"]
    _grads_close(got, ref)


def test_conditional_gaot_matches_jax():
    """A conditional-norm GAOT (a ConditionedNorm before each attention and
    after each FFN), the torch_parity workload: the strict weight carry
    (``...{attn,ffn}.correction.{mlp_scale,mlp_bias}.layers.0``), the
    forward and every gradient against jax.grad."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.models import GAOT
    from gaot_torch.train.static_trainer import masked_mse
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, load_flax_params
    from gaot_tpu.core.config import ModelConfig as JModelConfig
    from gaot_tpu.core.config import merge_config as jmerge
    from gaot_tpu.models import GAOT as JGAOT
    from gaot_tpu.train.static_trainer import masked_mse as jmse

    cfg = copy.deepcopy(tp.MODEL_CFG)
    cfg["use_conditional_norm"] = True
    cfg["args"]["transformer"]["attn_config"]["use_conditional_norm"] = True
    coords, lat, pndata, target = tp.workload()
    cond = np.random.default_rng(5).normal(size=(tp.BATCH, 1)).astype(np.float32)
    jcfg = jmerge(JModelConfig, cfg)
    enc, dec, enc_t, dec_t = tp.jax_graphs(coords, lat, jcfg)
    jm = JGAOT(input_size=tp.IN_CH, output_size=tp.OUT_CH, config=jcfg)
    args = (jnp.asarray(lat), jnp.asarray(coords), jnp.asarray(pndata), enc, dec)
    kw = dict(encoder_tgraphs=enc_t, decoder_tgraphs=dec_t, condition=jnp.asarray(cond))
    params = jax.jit(lambda k: jm.init(k, *args, **kw))(jax.random.key(0))

    def loss_fn(p):
        pred = jm.apply(p, *args, training=True, **kw)
        return jmse(pred, jnp.asarray(target), jnp.ones(tp.BATCH, bool)), pred

    (_, want), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    params = jax.tree.map(np.asarray, params)

    tcfg = merge_config(ModelConfig, cfg)
    te, td, tet, tdt = tp.torch_graphs(coords, lat, tcfg)
    model = GAOT(tp.IN_CH, tp.OUT_CH, tcfg, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert "processor.middle_layer.ffn.correction.mlp_bias.layers.0.weight" in names
    load_flax_params(model, params)
    model.train()
    pred = model(torch.from_numpy(lat), torch.from_numpy(coords), torch.from_numpy(pndata),
                 te, td, encoder_tgraphs=tet, decoder_tgraphs=tdt,
                 condition=torch.from_numpy(cond))
    masked_mse(pred, torch.from_numpy(target), torch.ones(tp.BATCH, dtype=torch.bool)).backward()
    np.testing.assert_allclose(tp.to_np(pred), np.asarray(want), rtol=1e-4, atol=1e-5)
    _grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                 flax_to_torch_state_dict(jax.tree.map(np.asarray, jg)))
