"""The port's sequential trainer on the CPU (``setup.device: "cpu"``), at
the JAX package's toy sizes (``tests/test_train_e2e.py``'s TINY_MODEL and
TINY_OPT).

- Parity: both packages' SequentialTrainers built from one config, the
  port given JAX's initial parameters strictly, both fitted in fp32
  (:func:`fit_against_jax`): the loss records within rtol 2e-4, the three
  rollout errors within rtol 1e-3, each restored parameter within 1e-3 of
  its tensor's largest entry; fx, and fx with the time-conditional norm
  (the start time as the condition of the processor's ConditionedNorms).
  vx: ``tests/test_torch_seq_vx_trainer.py``.
- The counterparts of ``tests/test_train_e2e.py``'s stepper-mode and
  short-trajectory cases (the end-to-end ones and the examples through
  the CLI: ``tests/test_torch_seq_cli.py``), and a checkpoint resume.
"""
import copy
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_sequential_fx_dataset  # noqa: E402
from test_torch_sequential import vx_metadata  # noqa: E402
from test_train_e2e import TINY_MODEL, TINY_OPT, _paths  # noqa: E402

ERRORS = ("relative error (direct)", "relative error (auto2)", "relative error (auto4)")


def _config(tmp_path, name, dataset, epochs=2, cond=False):
    """A sequential toy config on the CPU: TINY_MODEL (with the
    time-conditional norm where ``cond``), TINY_OPT for ``epochs``, the
    JAX e2e cases' dataset keys under ``dataset``."""
    model = copy.deepcopy(TINY_MODEL)
    if cond:
        model["use_conditional_norm"] = True
        model["args"]["transformer"]["attn_config"]["use_conditional_norm"] = True
    ds = {"base_path": str(tmp_path), "max_time_diff": 14, "time_step": 2,
          "stepper_mode": "time_der", "predict_mode": "all", "metric": "final_step"}
    ds.update(dataset)
    return {"setup": {"seed": 0, "trainer_name": "sequential", "train": True,
                      "device": "cpu"},
            "model": model, "dataset": ds,
            "optimizer": {**TINY_OPT, "args": {**TINY_OPT["args"], "epoch": epochs}},
            "path": _paths(tmp_path, name)}


FX = {"name": "ns_toy", "metaname": "incompressible_fluids/NS-Gauss",
      "train_size": 10, "val_size": 3, "test_size": 3, "batch_size": 8, "shuffle": True}


def fit_against_jax(tmp_path, monkeypatch, dataset, epochs=4, cond=False):
    """Both packages' SequentialTrainers from one config (``dataset`` over
    :func:`_config`'s), the port given JAX's initial weights strictly, both
    fitted: the loss records within rtol 2e-4, the three rollout errors
    within rtol 1e-3, each restored parameter within 1e-3 of its tensor's
    largest entry. Returns the port's trainer."""
    import jax

    from gaot_torch.train import SequentialTrainer
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, load_flax_params
    from gaot_tpu.train import SequentialTrainer as JTrainer

    # The plots are not compared; drawing them takes seconds a fit.
    monkeypatch.setattr(JTrainer, "_plot_results", lambda self, example: None)
    monkeypatch.setattr(SequentialTrainer, "_plot_results", lambda self, example: None)
    trainers = {}
    with vx_metadata():
        for side, cls in (("jax", JTrainer), ("torch", SequentialTrainer)):
            (tmp_path / side).mkdir()
            cfg = _config(tmp_path, "toy", dataset, epochs=epochs, cond=cond)
            cfg["path"] = _paths(tmp_path / side, "toy")
            trainers[side] = cls(cfg)
    jt, pt = trainers["jax"], trainers["torch"]
    assert pt.coord_mode == jt.coord_mode
    load_flax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    assert pt.datarow["nparams"] == jt.datarow["nparams"]

    jt.fit(verbose=False)
    pt.fit(verbose=False)
    got = np.load(tmp_path / "torch" / "toy_loss.npz")
    want = np.load(tmp_path / "jax" / "toy_loss.npz")
    np.testing.assert_array_equal(got["epochs"], want["epochs"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(got["val_losses"], want["val_losses"], rtol=2e-4)
    for key in ERRORS:
        assert np.isfinite(pt.datarow[key]) and pt.datarow[key] > 0, key
        np.testing.assert_allclose(pt.datarow[key], jt.datarow[key], rtol=1e-3, err_msg=key)
    ref = flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params))
    ours = pt.model.state_dict()
    assert ref.keys() == ours.keys()
    for k, w in ref.items():
        assert np.abs(ours[k].numpy() - w).max() <= 1e-3 * np.abs(w).max(), k
    assert pt.step == len(pt.train_loader) * epochs
    return pt


# The conditional norm's fit is held over 2 epochs: by the fourth, one
# entry of the encoder embedding's first (ReLU) layer bias, one unit of
# 64, drifts to 1.4e-2 of its tensor's largest entry while every other
# entry stays within 1e-6 of its own (a CPU reading of this test at 4
# epochs). A node whose pre-activation sits at the ReLU's kink rounds to
# either side in fp32 on one package and not the other, which switches
# that node's share of the gradient on or off, and AdamW keeps the step.
@pytest.mark.parametrize("cond", [False, True], ids=["fx", "fx_conditional_norm"])
def test_fit_matches_jax(tmp_path, monkeypatch, cond):
    make_sequential_fx_dataset(str(tmp_path / "ns_toy.npz"))
    pt = fit_against_jax(tmp_path, monkeypatch, FX, epochs=2 if cond else 4, cond=cond)
    assert pt.coord_mode == "fx"


@pytest.mark.parametrize("stepper_mode", ["output", "residual"])
def test_sequential_stepper_modes(tmp_path, stepper_mode):
    """tests/test_train_e2e.py::test_sequential_stepper_modes."""
    from gaot_torch.core.config import DatasetConfig, merge_config
    from gaot_torch.core.metadata import DATASET_METADATA
    from gaot_torch.data.sequential import DynamicPairBatcher, SequentialDataProcessor

    make_sequential_fx_dataset(str(tmp_path / "ns_toy.npz"))
    cfg = merge_config(DatasetConfig, {
        "name": "ns_toy", "metaname": "incompressible_fluids/NS-Gauss",
        "base_path": str(tmp_path), "train_size": 10, "val_size": 3,
        "test_size": 3, "stepper_mode": stepper_mode})
    proc = SequentialDataProcessor(cfg, DATASET_METADATA[cfg.metaname])
    splits, is_vx = proc.load_and_process_data()
    assert not is_vx
    batcher = DynamicPairBatcher(
        splits["train"]["u"], splits["train"]["c"], splits["train"]["t"],
        cfg.max_time_diff, cfg.time_step, stepper_mode, proc.stats)
    batch = batcher.get_batch(np.arange(4))
    u_dim = splits["train"]["u"].shape[-1]
    assert batch["input"].shape[-1] == u_dim + 2
    assert batch["target"].shape[-1] == u_dim
    # normalised targets: about zero mean, unit-ish scale
    full = batcher.get_batch(np.arange(len(batcher)))
    assert abs(full["target"].mean()) < 1.0
    assert 0.1 < full["target"].std() < 10.0


def test_sequential_short_trajectory_and_no_test_split(tmp_path):
    """tests/test_train_e2e.py::test_sequential_short_trajectory_and_no_test_split:
    max_time_diff < 14 evaluates (the predict-mode indices adapt), and a
    config without a test split builds its model and steps."""
    from gaot_torch.train import SequentialTrainer

    make_sequential_fx_dataset(str(tmp_path / "ns_short.npz"), num_timesteps=11)
    ds = dict(FX, name="ns_short", train_size=8, val_size=2, test_size=3,
              batch_size=4, max_time_diff=10)
    trainer = SequentialTrainer(_config(tmp_path, "seq_short", ds, epochs=1))
    trainer.fit(verbose=False)
    for key in ERRORS[:2]:
        assert np.isfinite(trainer.datarow[key])

    ds = dict(ds, test_size=0)
    t2 = SequentialTrainer(_config(tmp_path, "notest", ds, epochs=1))
    loss = float(t2.train_step(next(iter(t2.train_loader))))
    assert np.isfinite(loss)


def test_checkpoint_resume(tmp_path):
    """A fresh trainer resumes a fit's checkpoint: the weights and the
    optimizer state bit for bit, the update count (the schedule's
    position), then one more step."""
    from gaot_torch.train import SequentialTrainer
    from test_torch_trainer import _assert_states_equal, _state

    make_sequential_fx_dataset(str(tmp_path / "ns_toy.npz"))
    cfg = _config(tmp_path, "resume", dict(FX, predict_mode="direct"))
    trainer = SequentialTrainer(cfg)
    trainer.fit(verbose=False)
    steps = len(trainer.train_loader) * 2
    assert trainer.step == steps
    weights = _state(trainer.model)
    opt_state = copy.deepcopy(trainer.optimizer.state_dict())

    fresh = SequentialTrainer(cfg)
    assert fresh.step == 0 and not fresh.optimizer.state
    fresh.load_ckpt()
    assert fresh.step == steps
    _assert_states_equal(_state(fresh.model), weights)
    _assert_states_equal(fresh.optimizer.state_dict(), opt_state)
    loss = float(fresh.train_step(next(iter(fresh.train_loader))))
    assert np.isfinite(loss) and fresh.step == steps + 1
    assert fresh.optimizer.param_groups[0]["lr"] == fresh.schedule(steps)


