"""The port's fx static trainer, checkpoints and CLI on the CPU
(``setup.device: "cpu"``), at the JAX package's toy sizes
(``tests/test_train_e2e.py``'s TINY_MODEL and TINY_OPT).

- Parity: both packages' StaticTrainers built from one config, the port
  given JAX's initial parameters strictly, both fitted in fp32: the loss
  records within rtol 2e-4, the relative error within rtol 1e-3, each
  restored parameter within 1e-3 of its tensor's largest entry, and the
  same parameter count and bytes.
- Checkpoints: a bitwise round trip; a resume restores the optimizer state
  and the update count (the schedule's position); the best evaluation's
  weights come back at the end of a fit.
- CLI: the datarow's columns, a CSV database shared with the JAX CLI, ``-f``
  through ``python -m gaot_torch.cli`` subprocesses, ``setup.profile_dir``.
- What was refused: a mesh that does not fit the processes and a
  distributed run without a rendezvous raise what they need; the vx options
  that were refused build, and the sequential trainer with edge drop and
  with attention dropout, which are ported, trains through the CLI.
"""
import copy
import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_static_fx_dataset, make_static_vx_dataset  # noqa: E402
from test_train_e2e import TINY_MODEL, TINY_OPT, _paths  # noqa: E402


def _config(tmp_path, name, setup=None, dataset=None, data=True):
    if data:
        make_static_fx_dataset(str(tmp_path / f"{name}.npz"))
    s = {"seed": 0, "trainer_name": "static", "train": True, "device": "cpu"}
    s.update(setup or {})
    d = {"name": name, "metaname": "elliptic_pdes/Poisson-Gauss",
         "base_path": str(tmp_path), "train_size": 8, "val_size": 2,
         "test_size": 2, "batch_size": 4}
    d.update(dataset or {})
    return {"setup": s, "model": copy.deepcopy(TINY_MODEL), "dataset": d,
            "optimizer": copy.deepcopy(TINY_OPT), "path": _paths(tmp_path, name)}


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_states_equal(a, b):
    """Equal nested dicts, lists and tuples of tensors and plain values,
    tensors bit for bit."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_states_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_states_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_fit_matches_jax(tmp_path):
    import jax

    from gaot_torch.train import StaticTrainer
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, load_flax_params
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    make_static_fx_dataset(str(tmp_path / "toy.npz"))
    cfgs = {}
    for side in ("jax", "torch"):
        cfg = _config(tmp_path, "toy", data=False)
        cfg["path"] = _paths(tmp_path / side, "toy")
        cfgs[side] = cfg
    jt = JStaticTrainer(cfgs["jax"])
    pt = StaticTrainer(cfgs["torch"])
    load_flax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    assert pt.datarow["nparams"] == jt.datarow["nparams"]
    assert pt.datarow["nbytes"] == jt.datarow["nbytes"]

    jt.fit(verbose=False)
    pt.fit(verbose=False)
    got = np.load(tmp_path / "torch" / "toy_loss.npz")
    want = np.load(tmp_path / "jax" / "toy_loss.npz")
    assert sorted(got.files) == sorted(want.files) == [
        "epochs", "losses", "val_epochs", "val_losses"]
    np.testing.assert_array_equal(got["epochs"], want["epochs"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(got["val_losses"], want["val_losses"], rtol=2e-4)
    np.testing.assert_allclose(pt.datarow["relative error (direct)"],
                               jt.datarow["relative error (direct)"], rtol=1e-3)
    ref = flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params))
    ours = pt.model.state_dict()
    assert ref.keys() == ours.keys()
    for k, w in ref.items():
        err = np.abs(ours[k].numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max(), (k, err)
    assert pt.step == jt.train_loader.__len__() * TINY_OPT["args"]["epoch"]


def test_checkpoint_round_trip_and_resume(tmp_path):
    from gaot_torch.train import StaticTrainer
    from gaot_torch.train.checkpoint import checkpoint_file

    cfg = _config(tmp_path, "resume")
    trainer = StaticTrainer(cfg)
    trainer.fit(verbose=False)
    assert os.path.exists(checkpoint_file(cfg["path"]["ckpt_path"]))
    steps = len(trainer.train_loader) * TINY_OPT["args"]["epoch"]
    assert trainer.step == steps
    weights, opt_state = _state(trainer.model), copy.deepcopy(trainer.optimizer.state_dict())
    trainer.load_ckpt()                      # bitwise round trip
    _assert_states_equal(_state(trainer.model), weights)

    fresh = StaticTrainer(cfg)
    assert fresh.step == 0 and not fresh.optimizer.state
    fresh.load_ckpt()
    assert fresh.step == steps               # the schedule continues from here
    _assert_states_equal(_state(fresh.model), weights)
    _assert_states_equal(fresh.optimizer.state_dict(), opt_state)
    loss = float(fresh.train_step(next(iter(fresh.train_loader))))
    assert np.isfinite(loss) and fresh.step == steps + 1
    assert fresh.optimizer.param_groups[0]["lr"] == fresh.schedule(steps)


def test_fit_restores_best_evaluation(tmp_path):
    from gaot_torch.train import StaticTrainer

    trainer = StaticTrainer(_config(tmp_path, "best"))
    seen = []

    def validate(loader):                    # lowest at the first evaluation
        seen.append(_state(trainer.model))
        return [0.1, 0.5][len(seen) - 1]

    trainer.validate = validate
    trainer.fit(verbose=False)
    assert len(seen) == 2
    assert not all(torch.equal(seen[0][k], seen[1][k]) for k in seen[0])
    _assert_states_equal(_state(trainer.model), seen[0])
    rec = np.load(tmp_path / "best_loss.npz")
    np.testing.assert_array_equal(rec["val_losses"], [0.1, 0.5])


def test_cli_writes_datarow_and_profile(tmp_path):
    from gaot_torch.cli import main
    from gaot_tpu.cli import _make_datarow

    cfg = _config(tmp_path, "cli", setup={"profile_dir": str(tmp_path / "trace")})
    cfg["path"] = {k: os.path.join("out", os.path.basename(v))     # relative
                   for k, v in cfg["path"].items()}
    path = tmp_path / "cli.json"
    path.write_text(json.dumps(cfg))
    assert main(["-c", str(path)]) == 0
    with open(tmp_path / "out" / "cli_db.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert list(rows[0]) == list(_make_datarow(cfg, str(path)))
    assert np.isfinite(float(rows[0]["relative error (direct)"]))
    assert float(rows[0]["samples_per_sec"]) > 0
    assert int(rows[0]["nparams"]) > 0
    assert (tmp_path / "out" / "cli_loss.npz").exists()
    assert (tmp_path / "out" / "cli_ckpt.pt").exists()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_csv_database_shared_with_jax_cli(tmp_path):
    import pandas as pd

    from gaot_torch.cli import _append_csv, _make_datarow
    from gaot_tpu.cli import _append_csv as jappend
    from gaot_tpu.cli import _make_datarow as jrow

    raw = _config(tmp_path, "db", data=False)
    db = str(tmp_path / "db" / "db.csv")
    jr = jrow(raw, "a.json")
    jr.update(nparams=10, nbytes=40, **{"relative error (direct)": 0.25})
    jappend(db, jr)
    row = _make_datarow(raw, "b.json")
    row.update(nparams=11, nbytes=44, extra="new column")
    _append_csv(db, row)
    out = pd.read_csv(db)
    assert list(out.columns) == list(jr) + ["extra"]
    assert len(out) == 2
    assert out["nparams"].tolist() == [10, 11]
    assert out["relative error (direct)"].iloc[0] == 0.25
    assert np.isnan(out["relative error (direct)"].iloc[1])
    assert np.isnan(out["extra"].iloc[0]) and out["extra"].iloc[1] == "new column"
    assert out["model"].iloc[1] == repr(raw["model"])


def test_cli_folder_runs_subprocesses(tmp_path):
    from gaot_torch.cli import main

    folder = tmp_path / "cfgs"
    folder.mkdir()
    for name in ("f1", "f2"):
        cfg = _config(tmp_path, name,
                      dataset={"train_size": 4, "val_size": 2, "test_size": 2})
        cfg["optimizer"]["args"]["epoch"] = 2
        (folder / f"{name}.json").write_text(json.dumps(cfg))
    assert main(["-f", str(folder), "--jobs", "2"]) == 0
    for name in ("f1", "f2"):
        assert (tmp_path / f"{name}_db.csv").exists()
        assert (tmp_path / f"{name}_loss.npz").exists()


@pytest.mark.parametrize("what", ["vx", "sequential", "distributed", "model_parallel",
                                  "device"])
def test_refuses_what_is_not_ported(tmp_path, what):
    from gaot_torch.cli import main
    from gaot_torch.train import StaticTrainer

    if what == "vx":
        # vx trains (tests/test_torch_vx_trainer.py), and what was refused
        # here builds now: a nonlinear transform (dense graphs), the
        # on-disk graph cache (a file written) and training without the
        # transpose graphs (none built).
        make_static_vx_dataset(str(tmp_path / "vx.npz"))
        cfg = _config(tmp_path, "vx", data=False,
                      dataset={"metaname": "compressible_flow/naca0012"})
        cfg["model"]["args"]["magno"]["transform_type"] = "nonlinear"
        trainer = StaticTrainer(cfg)
        batch = next(iter(trainer.train_loader))
        # (the linear transform buckets this decoder graph)
        assert "dec_idx_0" in batch and "dec_b0_idx_0" not in batch
        cfg = _config(tmp_path, "vx", data=False,
                      dataset={"metaname": "compressible_flow/naca0012",
                               "graph_cache_dir": str(tmp_path / "cache")})
        StaticTrainer(cfg)
        assert len(list((tmp_path / "cache").glob("graphs_vx-*.npz"))) == 1
        cfg = _config(tmp_path, "vx", data=False,
                      dataset={"metaname": "compressible_flow/naca0012"})
        cfg["model"]["args"]["magno"]["use_transpose_backward"] = False
        trainer = StaticTrainer(cfg)
        assert not any("_tg" in k or "_tinv_" in k or "_tpos_" in k
                       for k in next(iter(trainer.train_loader)))
    elif what == "sequential":
        # The sequential trainer trains (tests/test_torch_seq_*.py), with
        # edge drop and with attention dropout too (both ported): each
        # trains through the CLI, its loss record finite.
        from synthetic import make_sequential_fx_dataset

        make_sequential_fx_dataset(str(tmp_path / "seq.npz"))
        for option in ("edge drop", "attention dropout"):
            name = option.replace(" ", "_")
            cfg = _config(tmp_path, name, data=False,
                          setup={"trainer_name": "sequential"},
                          dataset={"name": "seq",
                                   "metaname": "incompressible_fluids/NS-Gauss"})
            args = cfg["model"]["args"]
            if option == "edge drop":
                args["magno"].update(sampling_strategy="ratio", sample_ratio=0.5)
            else:
                args["transformer"]["attn_config"]["atten_dropout"] = 0.1
            path = tmp_path / f"{name}.json"
            path.write_text(json.dumps(cfg))
            assert main(["-c", str(path)]) == 0
            rec = np.load(tmp_path / f"{name}_loss.npz")
            assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    elif what == "device":
        if torch.cuda.is_available():
            pytest.skip("a card is present: 'auto' takes it")
        for device in ("auto", "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                StaticTrainer(_config(tmp_path, "dev", setup={"device": device}))
    elif what == "distributed":
        # Multi-GPU training is ported (tests/test_torch_parallel.py): a
        # distributed run with no rendezvous (no torchrun environment, no
        # coordinator address) says what it needs.
        with pytest.raises(ValueError, match="rendezvous"):
            StaticTrainer(_config(tmp_path, what, setup={"distributed": True}))
    else:
        # One process is a world of one rank: a mesh of two model ranks
        # does not fit it (no device is left idle, unlike the JAX mesh).
        for setup in ({"model_parallel": 2}, {"data_parallel": 2}):
            with pytest.raises(ValueError, match="world size 1"):
                StaticTrainer(_config(tmp_path, what, setup=setup))
