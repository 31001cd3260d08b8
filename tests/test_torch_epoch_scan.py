"""The port's epoch path (``setup.epoch_scan``; ``gaot_torch/train/graphed.py``)
on the CPU, at the JAX package's toy sizes (``tests/test_train_e2e.py``'s
TINY_MODEL and TINY_OPT). On the CPU the epoch path runs its step body
uncaptured; on the card the same body is captured as a CUDA graph and
replayed (``chip_smoke.py`` phase 11 holds that against the per-step path).

- ``BatchLoader.epoch_index_matrix`` equals ``gaot_tpu``'s for the same
  seed, sizes and shuffle over two epochs, and the order ``__iter__``
  gives.
- The epoch path against the per-step path, static fx, static vx and
  sequential fx, and static fx with edge drop (the draws from one
  generator seed): the same losses and weights bit for bit (one body,
  the same batches, the same learning rates, the same draws in the same
  order).
- The epoch path against ``gaot_tpu``'s ``train_epoch_scan`` from JAX's
  initial weights, two epochs (one JAX fit shared by a module fixture):
  the losses within rtol 1e-5, as ``tests/test_epoch_scan.py`` holds the
  JAX package's scan against its per-step path.
- The route: "never", "always" and "auto" on the CPU and (decided without
  a card) on the card, on one rank and on several, with batches gathered
  on the device, assembled on the host (``device_data`` off, or the split
  above ``DEVICE_DATA_BYTE_LIMIT``) from host buffers or (the sequential
  loader) without them: "always" steps one by one exactly where
  ``gaot_tpu`` does (one rank with host batches; several ranks with no
  host buffers or above the limit), with the reason; and the route line a
  fit prints. A one-rank fit under "always" with ``device_data`` off
  against ``gaot_tpu``'s fit of the same config (both step by step): the
  loss records within rtol 1e-5. The epoch path under several ranks:
  ``tests/test_torch_epoch_ranks.py``.
- The rollout through ``RolloutProgram`` (uncaptured on the CPU) against
  the loop of ``autoregressive_predict`` (bit for bit) and ``gaot_tpu``'s
  rollout (each step within 1e-5 of its largest entry), every predict
  mode, fx and vx.
"""
import copy
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import (  # noqa: E402
    make_sequential_fx_dataset,
    make_sequential_vx_dataset,
    make_static_fx_dataset,
    make_static_vx_dataset,
)
from test_torch_sequential import VX_META, vx_metadata  # noqa: E402
from test_train_e2e import TINY_MODEL, TINY_OPT, _paths  # noqa: E402


def _config(tmp, case, name, epoch_scan="always", magno=None, **dataset):
    """A tiny config of ``case`` (static fx, static vx, sequential fx or
    vx) on the CPU, its dataset written once."""
    ds = {"base_path": str(tmp), "train_size": 10, "val_size": 2, "test_size": 3,
          "batch_size": 4, "shuffle": True, "device_data": True}
    seq = case.startswith("seq")
    if case == "fx":
        ds.update(name="fx_toy", metaname="elliptic_pdes/Poisson-Gauss")
        make = make_static_fx_dataset
    elif case == "vx":
        ds.update(name="airfoil_toy", metaname="compressible_flow/naca0012",
                  train_size=7)
        make = make_static_vx_dataset
    else:
        ds.update(name=f"{case}_toy", train_size=4, max_time_diff=6, time_step=2,
                  stepper_mode="time_der", predict_mode="all", metric="final_step",
                  metaname=VX_META if case == "seq_vx" else "incompressible_fluids/NS-Gauss")
        make = make_sequential_vx_dataset if case == "seq_vx" else make_sequential_fx_dataset
    ds.update(dataset)
    path = tmp / f"{ds['name']}.npz"
    if not path.exists():
        make(str(path))
    model = copy.deepcopy(TINY_MODEL)
    model["args"]["magno"].update(magno or {})
    return {"setup": {"seed": 0, "trainer_name": "sequential" if seq else "static",
                      "train": True, "device": "cpu", "epoch_scan": epoch_scan},
            "model": model, "dataset": ds, "optimizer": copy.deepcopy(TINY_OPT),
            "path": _paths(tmp, name)}


def _trainer(cfg):
    from gaot_torch.train import SequentialTrainer, StaticTrainer

    cls = SequentialTrainer if cfg["setup"]["trainer_name"] == "sequential" else StaticTrainer
    with vx_metadata():
        return cls(cfg)


# ---------------------------------------------------------------------------
def test_epoch_index_matrix_matches_jax():
    from gaot_torch.data.loader import BatchLoader
    from gaot_tpu.data.loader import BatchLoader as JBatchLoader

    for n, bs, shuffle in ((10, 4, True), (12, 4, True), (7, 3, False)):
        ours = BatchLoader(n, bs, lambda idx: {"idx": idx}, shuffle=shuffle, seed=3)
        theirs = JBatchLoader(n, bs, lambda idx: {}, shuffle=shuffle, seed=3)
        twin = BatchLoader(n, bs, lambda idx: {"idx": idx}, shuffle=shuffle, seed=3)
        for _ in range(2):
            idx, mask = ours.epoch_index_matrix()
            jidx, jmask = theirs.epoch_index_matrix()
            assert idx.dtype == np.int64 and idx.shape == (len(ours), bs)
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(mask, jmask)
            it = list(twin)
            np.testing.assert_array_equal(idx, np.stack([b["idx"] for b in it]))
            np.testing.assert_array_equal(mask, np.stack([b["sample_mask"] for b in it]))


@pytest.mark.parametrize("case,magno", [
    ("fx", None), ("vx", None), ("seq", None),
    ("fx", {"sampling_strategy": "ratio", "sample_ratio": 0.5}),
], ids=["fx", "vx", "seq", "fx-edge-drop"])
def test_epoch_path_matches_per_step(tmp_path, case, magno):
    """Two epochs through the epoch path and through the per-step path from
    one trainer's initial state, bit for bit. Under edge drop both draw
    from the trainer's generator seeded alike, and their generators end in
    the same state."""
    from gaot_torch.train.graphed import EpochProgram

    a = _trainer(_config(tmp_path, case, "epoch", magno=magno))
    b = _trainer(_config(tmp_path, case, "step", "never", magno=magno))
    b.model.load_state_dict(a.model.state_dict())
    assert a.steps_route() == ("epoch", "setup.device cpu: the step body uncaptured")
    assert b.steps_route() == ("per-step", "setup.epoch_scan never")
    assert a.train_loader.device_epoch_spec is not None
    program = EpochProgram(a, capture=False)
    got, want, samples = [], [], 0
    for _ in range(2):
        losses, n = a.train_epoch(program)
        got.append(losses)
        samples += n
        for batch in b.train_loader:
            want.append(float(b.train_step(batch)))
    got = torch.cat(got).numpy()
    assert len(got) == 2 * len(a.train_loader) and a.step == b.step == len(got)
    assert samples == 2 * a.train_loader.num_samples
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.float32))
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    if magno:
        # The drop drew: the generator moved.
        fresh = torch.Generator().manual_seed(0).get_state()
        assert not torch.equal(a.generator.get_state(), fresh)


@pytest.fixture(scope="module")
def jax_scan(tmp_path_factory):
    """gaot_tpu's StaticTrainer (device data, epoch_scan always) and two
    epochs of its ``train_epoch_scan``: (the initial parameters, the [2k]
    losses, the parameters after)."""
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    tmp = tmp_path_factory.mktemp("jax_scan")
    cfg = _config(tmp, "fx", "jax")
    cfg["setup"]["data_parallel"] = 1
    jt = JStaticTrainer(cfg)
    params0 = jax.tree.map(np.asarray, jt.params)
    assert jt._scan_available()
    losses = np.concatenate([np.asarray(jt.train_epoch_scan()) for _ in range(2)])
    return tmp, params0, losses, jax.tree.map(np.asarray, jt.params)


def test_epoch_path_matches_jax_scan(jax_scan):
    from gaot_torch.train.graphed import EpochProgram
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, load_flax_params

    tmp, params0, want, params = jax_scan
    pt = _trainer(_config(tmp, "fx", "torch"))
    load_flax_params(pt.model, params0)
    program = EpochProgram(pt, capture=False)
    got = torch.cat([pt.train_epoch(program)[0] for _ in range(2)]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = flax_to_torch_state_dict(params)
    for k, v in pt.model.state_dict().items():
        err = np.abs(v.numpy() - ref[k]).max()
        assert err <= 1e-4 * np.abs(ref[k]).max(), (k, err)


# ---------------------------------------------------------------------------
class _Loader:
    def __init__(self, spec=True, reason="", nbytes=None):
        self.device_epoch_spec = ({}, None) if spec else None
        self.host_reason = reason
        self.host_buffers = None if nbytes is None else {"u": np.zeros(nbytes, np.uint8)}


def test_route_decision(monkeypatch):
    from gaot_torch.data import loader as loader_mod
    from gaot_torch.train.graphed import GRAPH_BREAK_EVEN_STEPS, choose_route

    monkeypatch.setattr(loader_mod, "DEVICE_DATA_BYTE_LIMIT", 1024)
    cpu, card = torch.device("cpu"), torch.device("cuda")
    dev, host = _Loader(), _Loader(False, "dataset.device_data is false: ...")
    placed = _Loader(False, "dataset.device_data is false: ...", nbytes=1024)
    big = _Loader(False, "dataset.device_data is false: ...", nbytes=1025)
    many = 10 * GRAPH_BREAK_EVEN_STEPS
    for world, loaders in ((1, (dev,)), (2, (dev, placed))):
        # Batches gathered on the device (or, under several ranks, from
        # host buffers each rank places): the epoch path.
        for ld in loaders:
            assert choose_route("never", card, world, ld, many) == ("per-step",
                                                                    "setup.epoch_scan never")
            assert choose_route("false", card, world, ld, many)[0] == "per-step"
            for mode in ("always", "true", "auto"):
                assert choose_route(mode, card, world, ld, many) == ("graph", "")
            assert choose_route("always", card, world, ld, 1) == ("graph", "")
            route, why = choose_route("auto", card, world, ld, GRAPH_BREAK_EVEN_STEPS - 1)
            assert route == "per-step" and "break-even" in why
            assert choose_route("auto", card, world, ld, GRAPH_BREAK_EVEN_STEPS)[0] == "graph"
            assert choose_route("always", cpu, world, ld, many)[0] == "epoch"
            assert choose_route("auto", cpu, world, ld, many) == (
                "per-step", "setup.device cpu: no CUDA graph")
    for device in (cpu, card):
        for mode in ("auto", "always"):
            # One rank with host batches: step by step, as gaot_tpu's fit.
            for ld in (host, placed, big):
                assert choose_route(mode, device, 1, ld, many) == ("per-step",
                                                                   host.host_reason)
            # Several ranks: the buffers above the limit, or none to place.
            route, why = choose_route(mode, device, 2, big, many)
            assert route == "per-step" and "DEVICE_DATA_BYTE_LIMIT" in why
            route, why = choose_route(mode, device, 2, host, many)
            assert route == "per-step" and why.startswith(host.host_reason)
            assert "no host buffers" in why


def test_route_of_host_batches(tmp_path, monkeypatch):
    """A split above DEVICE_DATA_BYTE_LIMIT, and device_data off, leave the
    loader on the host: one rank steps one by one, under "always" too, with
    the reason."""
    from gaot_torch.data import loader as loader_mod

    off = _trainer(_config(tmp_path, "fx", "off", "auto", device_data=False))
    assert off.train_loader.device_epoch_spec is None
    assert off.train_loader.host_buffers is not None
    assert off.steps_route() == ("per-step", off.train_loader.host_reason)
    monkeypatch.setattr(loader_mod, "DEVICE_DATA_BYTE_LIMIT", 1024)
    big = _trainer(_config(tmp_path, "fx", "big", "auto"))
    assert big.train_loader.device_epoch_spec is None
    route, why = big.steps_route()
    assert route == "per-step" and "DEVICE_DATA_BYTE_LIMIT" in why
    big.setup_config.epoch_scan = "always"
    assert big.steps_route() == (route, why)


def test_always_with_host_batches_fits_as_jax(tmp_path, capsys):
    """``epoch_scan: "always"`` with ``device_data`` off on one rank: the
    port's fit steps one by one and says why in its route line, and its
    loss record equals ``gaot_tpu``'s fit of the same config (whose
    ``_build_epoch_fn`` returns None there, so it steps one by one too)
    from JAX's initial weights within rtol 1e-5."""
    from gaot_torch.utils.routing import reset_routes
    from gaot_torch.utils.torch_interop import load_flax_params
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    trainers = {}
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        cfg = _config(tmp_path, "fx", "fit", device_data=False)
        cfg["path"] = _paths(tmp_path / side, "fit")
        if side == "jax":
            cfg["setup"].update(data_parallel=1)
            del cfg["setup"]["device"]
            trainers[side] = JStaticTrainer(cfg)
        else:
            trainers[side] = _trainer(cfg)
    jt, pt = trainers["jax"], trainers["torch"]
    assert not jt._scan_available()
    load_flax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    jt.fit(verbose=False)
    reset_routes()
    capsys.readouterr()
    pt.fit(verbose=True)
    routes = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[gaot_torch] kernel routes:")]
    assert len(routes) == 1, routes
    assert routes[0].endswith(f"steps=per-step ({pt.train_loader.host_reason})")
    got = np.load(tmp_path / "torch" / "fit_loss.npz")
    want = np.load(tmp_path / "jax" / "fit_loss.npz")
    np.testing.assert_array_equal(got["epochs"], want["epochs"])
    for key in ("losses", "val_losses"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode,line", [
    ("always", "steps=epoch (setup.device cpu: the step body uncaptured)"),
    ("never", "steps=per-step (setup.epoch_scan never)"),
])
def test_fit_prints_its_route(tmp_path, capsys, mode, line):
    from gaot_torch.utils.routing import reset_routes

    trainer = _trainer(_config(tmp_path, "fx", mode, mode))
    reset_routes()
    trainer.fit(verbose=True)
    routes = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[gaot_torch] kernel routes:")]
    assert len(routes) == 1 and routes[0].endswith(line), routes
    assert trainer.step == TINY_OPT["args"]["epoch"] * len(trainer.train_loader)
    assert np.isfinite(trainer.datarow["relative error (direct)"])


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rollout_trainers(tmp_path_factory):
    """Both packages' SequentialTrainers per case, the port's with JAX's
    initial weights (as ``tests/test_torch_seq_rollout.py`` builds them)."""
    from gaot_torch.utils.torch_interop import load_flax_params
    from gaot_tpu.train import SequentialTrainer as JTrainer

    out = {}
    for case in ("seq", "seq_vx"):
        tmp = tmp_path_factory.mktemp(case)
        cfg = _config(tmp, case, "torch", test_size=3, max_time_diff=14)
        with vx_metadata():
            jt = JTrainer(_config(tmp, case, "jax", test_size=3, max_time_diff=14))
        pt = _trainer(cfg)
        load_flax_params(pt.model, jax.tree.map(np.asarray, jt.params))
        pt.model.eval()
        out[case] = (jt, pt)
    return out


@pytest.mark.parametrize("mode", ["autoregressive", "direct", "star"])
@pytest.mark.parametrize("case", ["seq", "seq_vx"])
def test_rollout_program_matches_loop_and_jax(rollout_trainers, case, mode):
    from gaot_torch.data.graph_builder import vx_layout
    from gaot_torch.data.sequential import RolloutTestBatcher
    from gaot_torch.models.rollout import autoregressive_predict
    from gaot_torch.train import predict_mode_indices
    from gaot_torch.train.graphed import RolloutProgram
    from gaot_tpu.models.rollout import autoregressive_predict as jroll

    jt, pt = rollout_trainers[case]
    vx = case == "seq_vx"
    ti = predict_mode_indices(mode, 14, 2)
    te = pt.splits["test"]
    batcher = RolloutTestBatcher(te["u"], te["c"], ti, pt.stats,
                                 graphs=pt.vx_graphs["test"] if vx else None)
    program = RolloutProgram(pt.model, ti, pt.t_values, pt.stats, pt.stepper_mode,
                             lambda placed: pt._model_args(placed)[:2])
    for idx in (np.array([2, 0, 1]), np.array([1, 2, 0])):
        batch = batcher.get_batch(idx)
        if vx:
            batch.update(vx_layout(batcher.buffers, len(idx)))
        placed = pt.place_batch({k: v for k, v in batch.items() if k != "target"})
        got = program(placed).numpy()
        graphs, coord, _ = pt._model_args(placed)
        loop = autoregressive_predict(pt.model, placed["input"], ti, pt.t_values,
                                      pt.stats, pt.stepper_mode, graphs, coord).numpy()
        np.testing.assert_array_equal(got, loop)
        jbatch = {k: v for k, v in batch.items() if k in placed}
        jcoord, enc, dec, _, enc_t, dec_t = jt._graph_args(jbatch)
        want = np.asarray(jroll(jt.model, jt.params, jnp.asarray(batch["input"]), ti,
                                jt.t_values, jt.stats, jt.stepper_mode,
                                jt.latent_tokens_coord, jcoord, enc, dec,
                                encoder_tgraphs=enc_t, decoder_tgraphs=dec_t))
        assert got.shape == want.shape and got.shape[:2] == (3, len(ti) - 1)
        for s in range(got.shape[1]):
            err = np.abs(got[:, s] - want[:, s]).max()
            assert err <= 1e-5 * np.abs(want[:, s]).max(), (s, err)
