"""``autoregressive_predict`` of the port against the JAX package's on the
CPU (fp32), in every stepper mode ('output', 'residual', 'time_der') and
predict mode ('autoregressive', 'direct', 'star'), fx and vx: both
packages' SequentialTrainers are built on the same tiny data (the shapes
of ``tests/test_train_e2e.py``'s sequential cases), the port's given
JAX's initial weights strictly; one test batch of three trajectories
(``RolloutTestBatcher``, with the batch's vx layout) rolls out through
each package's function, and every step must lie within 1e-4 of that
step's largest entry (fp32 sums in other orders, fed back step to step).
"""
import copy
import functools
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_sequential_fx_dataset, make_sequential_vx_dataset  # noqa: E402
from test_torch_sequential import PREDICT, STEPPERS, VX_META, vx_metadata  # noqa: E402
from test_train_e2e import TINY_MODEL, TINY_OPT, _paths  # noqa: E402


def _seq_config(tmp, case, name):
    ds = {"base_path": str(tmp), "train_size": 6, "val_size": 2, "test_size": 3,
          "batch_size": 4, "max_time_diff": 14, "time_step": 2,
          "stepper_mode": "time_der", "predict_mode": "all", "metric": "final_step"}
    if case == "fx":
        ds.update(name="ns_toy", metaname="incompressible_fluids/NS-Gauss")
    else:
        ds.update(name="seq_vx_toy", metaname=VX_META)
    return {"setup": {"seed": 0, "trainer_name": "sequential", "train": True,
                      "device": "cpu"},
            "model": copy.deepcopy(TINY_MODEL), "dataset": ds,
            "optimizer": copy.deepcopy(TINY_OPT), "path": _paths(tmp, name)}


@functools.lru_cache(maxsize=None)
def _trainers(case):
    """Both packages' SequentialTrainers on one tiny dataset, the port's
    with JAX's initial weights."""
    import tempfile

    from gaot_torch.train import SequentialTrainer
    from gaot_torch.utils.torch_interop import load_flax_params
    from gaot_tpu.train import SequentialTrainer as JTrainer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="seq_rollout_"))
    if case == "fx":
        make_sequential_fx_dataset(str(tmp / "ns_toy.npz"), num_samples=11)
    else:
        make_sequential_vx_dataset(str(tmp / "seq_vx_toy.npz"), num_samples=11)
    with vx_metadata():
        jt = JTrainer(_seq_config(tmp, case, "jax"))
        pt = SequentialTrainer(_seq_config(tmp, case, "torch"))
    load_flax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    pt.model.eval()
    return jt, pt


@pytest.mark.parametrize("mode", PREDICT)
@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("case", ["fx", "vx"])
def test_rollout_matches_jax(case, stepper, mode):
    from gaot_torch.data.graph_builder import vx_layout
    from gaot_torch.data.sequential import RolloutTestBatcher
    from gaot_torch.models.rollout import autoregressive_predict
    from gaot_torch.train import predict_mode_indices
    from gaot_tpu.models.rollout import autoregressive_predict as jroll

    jt, pt = _trainers(case)
    assert pt.coord_mode == jt.coord_mode == case
    ti = predict_mode_indices(mode, 14, 2)
    te = pt.splits["test"]
    batcher = RolloutTestBatcher(te["u"], te["c"], ti, pt.stats,
                                 graphs=pt.vx_graphs["test"] if case == "vx" else None)
    idx = np.array([2, 0, 1])
    batch = batcher.get_batch(idx)
    if case == "vx":
        batch.update(vx_layout(batcher.buffers, len(idx)))
    placed = pt.place_batch({k: v for k, v in batch.items() if k != "target"})
    graphs, coord, _ = pt._model_args(placed)
    got = autoregressive_predict(pt.model, placed["input"], ti, pt.t_values, pt.stats,
                                 stepper, graphs, coord).numpy()

    jbatch = {k: v for k, v in batch.items() if k in placed}
    jcoord, enc, dec, _, enc_t, dec_t = jt._graph_args(jbatch)
    want = np.asarray(jroll(jt.model, jt.params, jnp.asarray(batch["input"]), ti,
                            jt.t_values, jt.stats, stepper, jt.latent_tokens_coord,
                            jcoord, enc, dec, encoder_tgraphs=enc_t,
                            decoder_tgraphs=dec_t))
    assert got.shape == want.shape and got.shape[:2] == (3, len(ti) - 1)
    assert np.isfinite(got).all()
    for s in range(got.shape[1]):
        err = np.abs(got[:, s] - want[:, s]).max()
        assert err <= 1e-4 * np.abs(want[:, s]).max(), (s, err)
