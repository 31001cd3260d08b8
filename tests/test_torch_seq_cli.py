"""The port's sequential trainer end to end on the CPU: the counterpart of
``tests/test_train_e2e.py::test_sequential_trainer_end_to_end`` (fx, 28
time pairs a sample, the three rollout errors, the result plot and the
rollout's GIF), and ``config/examples/time_dep/ns_gauss.json`` and
``ce_crp.json`` read from disk and trained through ``python -m
gaot_torch.cli -c`` on synthetic data at the Poseidon layout
(``tests/torch_synthetic.py``), cut for the CPU to a 32 x 32 lattice (the
sets' 128 x 128), 4 / 2 / 2 samples, 2 epochs, a 16 x 16 latent grid
(radius 0.033 -> 0.09, about the example's neighbours per latent point on
the coarser lattice) and a UViT at hidden 64.
"""
import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_sequential_fx_dataset  # noqa: E402
from test_torch_seq_trainer import ERRORS, FX, _config  # noqa: E402
from torch_synthetic import make_poseidon_sequential_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sequential_trainer_end_to_end(tmp_path):
    """tests/test_train_e2e.py::test_sequential_trainer_end_to_end."""
    from gaot_torch.train import SequentialTrainer

    make_sequential_fx_dataset(str(tmp_path / "ns_toy.npz"))
    trainer = SequentialTrainer(_config(tmp_path, "seq", FX))
    assert trainer.coord_mode == "fx"
    # lags {2, ..., 14} at stride 2 over 15 steps: 28 pairs a sample
    assert trainer.train_loader.num_samples == 10 * 28
    trainer.fit(verbose=False)
    for key in ERRORS:
        assert np.isfinite(trainer.datarow[key]) and trainer.datarow[key] > 0
    assert (tmp_path / "seq_result.png").exists()
    assert (tmp_path / "seq_result.gif").exists()


# The CPU cut of the two examples: lattice, samples, epochs, latent grid,
# radius and UViT width (module docstring).
CPU_GRID = 32


def example_cpu_config(folder: str, example: str) -> str:
    """config/examples/time_dep/<example>.json read from disk, set to the
    CPU with its data in ``folder`` and cut as the module docstring says.
    Returns the written config's path."""
    with open(os.path.join(ROOT, "config", "examples", "time_dep", f"{example}.json")) as f:
        raw = json.load(f)
    raw["setup"]["device"] = "cpu"
    raw["dataset"].update(base_path=folder, train_size=4, val_size=2, test_size=2)
    raw["optimizer"]["args"].update(epoch=2, eval_every_eps=2)
    raw["model"]["latent_tokens_size"] = [16, 16]
    raw["model"]["args"]["magno"]["radius"] = 0.09
    raw["model"]["args"]["transformer"]["hidden_size"] = 64
    raw["path"] = {k: os.path.join("out", k.split("_")[0], os.path.basename(v))
                   for k, v in raw["path"].items()}
    channels = 2 if example == "ns_gauss" else 4
    make_poseidon_sequential_dataset(
        os.path.join(folder, f"{raw['dataset']['name']}.npz"), num_samples=8,
        channels=channels, grid=CPU_GRID)
    path = os.path.join(folder, f"{example}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.mark.parametrize("example", ["ns_gauss", "ce_crp"])
def test_example_trains_through_the_cli(tmp_path, example):
    cfg = example_cpu_config(str(tmp_path), example)
    out = subprocess.run([sys.executable, "-m", "gaot_torch.cli", "-c", cfg],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "agno=bucketed:plain" in out.stdout or "agno=tgraph:plain" in out.stdout
    rec = np.load(tmp_path / "out" / "loss" / f"{example}.npz")
    assert len(rec["losses"]) == 1 and np.isfinite(rec["losses"]).all()
    with open(tmp_path / "out" / "database" / f"{example}.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    for key in ERRORS:
        assert np.isfinite(float(rows[0][key])), key
    assert (tmp_path / "out" / "ckpt" / f"{example}.pt").exists()
    for mode in ("autoregressive", "direct", "star"):
        assert f"{mode} mode error:" in out.stdout
