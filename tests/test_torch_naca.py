"""The naca0012 example and the trainers under edge drop and attention
dropout, on the CPU.

- ``config/examples/time_indep/naca0012.json`` (vx static, ``sampling_
  strategy: "max_neighbors"``, ``max_neighbors: 32``), read from disk,
  trains through ``gaot_torch.cli`` on the CPU on a small clustered airfoil
  layout (``tests/torch_synthetic.py::make_naca_dataset``), its sample
  counts, epochs, latent grid (64x64 → 16x16, the radius 0.033 → 0.14 to
  keep about the example's neighbours a latent point) and UViT width cut:
  the loss falls, the metric is finite, the encoder's graphs wider than
  32 are thinned to 32 edges a row in every step, and the decoder's (K at
  most 32) are left as they are, with no draw.
- The graphs placed on the device stay as built: two training steps with
  edge drop leave every tensor of the batch (vx: the graph buffers and
  their layout) and of the fx trainer's shared graphs bit for bit.
- A sequential step with ``sampling_strategy: "ratio"`` and attention
  dropout is finite and reproducible from its seed.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import _config  # noqa: E402
from torch_synthetic import make_naca_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def naca_cpu_config(folder: str, samples=(8, 2, 2), epochs: int = 4) -> str:
    """config/examples/time_indep/naca0012.json, read from disk, set to the
    CPU with its data in ``folder`` (the clustered airfoil layout, 768
    nodes a sample), cut as the module docstring says. Returns the written
    config's path."""
    with open(os.path.join(ROOT, "config", "examples", "time_indep",
                           "naca0012.json")) as f:
        raw = json.load(f)
    raw["setup"]["device"] = "cpu"
    raw["dataset"].update(base_path=folder, train_size=samples[0],
                          val_size=samples[1], test_size=samples[2], batch_size=4)
    raw["optimizer"]["args"].update(epoch=epochs, eval_every_eps=2)
    raw["model"]["latent_tokens_size"] = [16, 16]
    raw["model"]["args"]["magno"]["radius"] = 0.14
    raw["model"]["args"]["transformer"]["hidden_size"] = 64
    raw["path"] = {k: os.path.join(folder, "out", os.path.basename(v))
                   for k, v in raw["path"].items()}
    make_naca_dataset(os.path.join(folder, f"{raw['dataset']['name']}.npz"),
                      num_samples=sum(samples), num_nodes=768)
    path = os.path.join(folder, "naca0012.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _record_drops(monkeypatch):
    """Each edge-drop call of the model: (K, valid edges a row before,
    after, whether it drew)."""
    from gaot_torch.models import magno

    calls = []
    drop = magno.apply_edge_drop_mask

    def record(mask, generator, *args):
        out = drop(mask, generator, *args)
        calls.append((mask.shape[-1], mask.sum(-1), out.sum(-1), out is not mask))
        return out

    monkeypatch.setattr(magno, "apply_edge_drop_mask", record)
    return calls


def test_naca0012_trains_through_the_cli(tmp_path, monkeypatch):
    from gaot_torch import cli

    cfg = naca_cpu_config(str(tmp_path))
    calls = _record_drops(monkeypatch)
    assert cli.main(["-c", cfg]) == 0
    out = tmp_path / "out"
    rec = np.load(out / "naca0012.npz")
    assert rec["losses"][-1] < rec["losses"][0]
    with open(out / "naca0012.csv") as f:
        rows = f.read().splitlines()
    assert len(rows) == 2
    assert (out / "naca0012.pt").exists()
    # 4 epochs x 2 steps, each dropping on every bucket of both sides.
    steps = 4 * 2
    assert calls and len(calls) % steps == 0
    wide = [c for c in calls if c[0] > 32]
    assert wide and all(c[3] for c in wide)
    for k, before, after, _ in wide:
        assert torch.equal(after, before.clamp(max=32))
    assert (torch.cat([c[1] for c in wide]) > 32).any()      # thinned
    narrow = [c for c in calls if c[0] <= 32]
    assert narrow and not any(c[3] for c in narrow)          # no draw


def _tensors(obj, path="", out=None):
    """Every tensor in nested dicts, lists and tuples (NamedTuples too)."""
    out = {} if out is None else out
    if isinstance(obj, torch.Tensor):
        out[path] = obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _tensors(v, f"{path}.{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _tensors(v, f"{path}.{i}", out)
    return out


@pytest.mark.parametrize("mode", ["fx", "vx"])
def test_placed_graphs_unchanged_by_dropped_steps(tmp_path, mode, monkeypatch):
    from gaot_torch.train import StaticTrainer

    if mode == "vx":
        with open(naca_cpu_config(str(tmp_path))) as f:
            cfg = json.load(f)
    else:
        cfg = _config(tmp_path, "fx")
        cfg["model"]["args"]["magno"].update(sampling_strategy="ratio", sample_ratio=0.5)
    trainer = StaticTrainer(cfg)
    assert trainer.coord_mode == mode
    calls = _record_drops(monkeypatch)
    batch = trainer.place_batch(next(iter(trainer.train_loader)))
    placed = _tensors(batch) if mode == "vx" else _tensors(trainer.graphs)
    assert any(t.dtype == torch.bool for t in placed.values())
    before = {k: t.clone() for k, t in placed.items()}
    losses = [float(trainer.train_step(batch)) for _ in range(2)]
    assert np.isfinite(losses).all()
    assert any(c[3] for c in calls)                          # masks were thinned
    for k, t in placed.items():
        assert torch.equal(t, before[k]), k


def test_sequential_step_with_edge_drop_is_reproducible(tmp_path):
    from gaot_torch.train import SequentialTrainer
    from synthetic import make_sequential_fx_dataset

    make_sequential_fx_dataset(str(tmp_path / "seq.npz"))
    cfg = _config(tmp_path, "seq", data=False, setup={"trainer_name": "sequential"},
                  dataset={"metaname": "incompressible_fluids/NS-Gauss"})
    cfg["model"]["args"]["magno"].update(sampling_strategy="ratio", sample_ratio=0.5)
    cfg["model"]["args"]["transformer"]["attn_config"]["atten_dropout"] = 0.1
    runs = []
    for _ in range(2):
        trainer = SequentialTrainer(copy.deepcopy(cfg))
        batches = iter(trainer.train_loader)
        runs.append([float(trainer.train_step(next(batches))) for _ in range(2)])
    assert np.isfinite(runs).all()
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]
