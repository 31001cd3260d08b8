"""The port's vx sequential trainer (a mesh per sample, fixed over each
trajectory) on the CPU, on ``tests/synthetic.py::
make_sequential_vx_dataset`` (80 nodes a sample, padded to 128), the
metadata of ``tests/test_train_e2e.py``'s vx case.

- Parity with the JAX package's fit (``tests/test_torch_seq_trainer.py::
  fit_against_jax``): a batch of 8 pairs from 6 training samples, so every
  batch holds some sample under two time pairs, each slot with its own
  copy of that sample's graphs, coordinates and node mask.
- The counterpart of ``tests/test_train_e2e.py::
  test_sequential_trainer_vx_end_to_end``.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_sequential_vx_dataset  # noqa: E402
from test_torch_seq_trainer import _config, fit_against_jax  # noqa: E402
from test_torch_sequential import VX_META, vx_metadata  # noqa: E402

VX = {"name": "seq_vx_toy", "metaname": VX_META, "train_size": 6, "val_size": 2,
      "test_size": 2, "batch_size": 8, "stepper_mode": "output",
      "predict_mode": "all"}


def test_vx_fit_matches_jax(tmp_path, monkeypatch):
    make_sequential_vx_dataset(str(tmp_path / "seq_vx_toy.npz"))
    pt = fit_against_jax(tmp_path, monkeypatch, VX)
    assert pt.coord_mode == "vx"
    # More pairs a batch than samples: every batch repeats a sample.
    assert pt.train_loader.batch_size > pt.splits["train"]["u"].shape[0]
    batch = next(iter(pt.test_loader))
    assert batch["x"].shape[1] == 128 and not batch["node_mask"][:, 80:].any()


def test_sequential_trainer_vx_end_to_end(tmp_path):
    """tests/test_train_e2e.py::test_sequential_trainer_vx_end_to_end."""
    from gaot_torch.train import SequentialTrainer

    make_sequential_vx_dataset(str(tmp_path / "seq_vx_toy.npz"))
    ds = dict(VX, batch_size=4, predict_mode="autoregressive")
    with vx_metadata():
        trainer = SequentialTrainer(_config(tmp_path, "seq_vx", ds))
    assert trainer.coord_mode == "vx"
    trainer.fit(verbose=False)
    assert np.isfinite(trainer.datarow["relative error (autoregressive)"])
