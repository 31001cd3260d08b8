"""The port's epoch path (``gaot_torch/train/graphed.py``) under several
ranks on the CPU: two gloo ranks (``tests/torch_dist.py``), the step body
uncaptured, at the toy sizes of ``tests/test_torch_epoch_scan.py``. Every
rank holds the epoch's whole index and mask tables and each step keeps its
share of the row, as ``gaot_tpu``'s scan shards the table over 'data'. On
the card the same body is captured over NCCL (``chip_smoke.py`` phase 12).

One start of the ranks runs every mesh, two epochs each way:

- the epoch path against the per-step path (two trainers from the same
  weights): the losses, the weights after and the generator's state bit
  for bit (one body, the same batches, rates and draws) on fx at dp 2
  (with batches gathered on the device; with edge drop; with
  ``device_data`` off, its host buffers placed on each rank), fx at tp 2,
  vx at dp 2 (each rank its samples' rows of the layout's row maps, as
  ``shard_batch`` keeps them) and at sp 2, and sequential fx at dp 2;
- fx at dp 2 (device buffers and placed host buffers) and at tp 2 from
  JAX's initial weights against ``gaot_tpu``'s ``train_epoch_scan`` on its
  (2, 1) and (1, 2) meshes of the conftest's virtual devices: the losses
  within rtol 1e-5 (``test_epoch_path_matches_jax_scan``'s), each weight
  within 1e-5 of its tensor's largest entry plus 1e-4 of its largest update
  (``test_torch_parallel.py::_close``: AdamW carries a gradient's relative
  rounding into its update).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist as td  # noqa: E402
from test_torch_epoch_scan import _config  # noqa: E402
from test_torch_parallel import _close  # noqa: E402

EDGE_DROP = {"sampling_strategy": "ratio", "sample_ratio": 0.5}
DP2 = {"data_parallel": 2, "model_parallel": 1}
TP2 = {"data_parallel": 1, "model_parallel": 2}
# name: (config case, mesh, magno options, dataset options, JAX mesh's case)
CASES = {
    "fx_dp2": ("fx", DP2, None, {}, "fx_dp2"),
    "fx_dp2_edge_drop": ("fx", DP2, EDGE_DROP, {}, None),
    "fx_dp2_host_batches": ("fx", DP2, None, {"device_data": False}, "fx_dp2"),
    "fx_tp2": ("fx", TP2, None, {}, "fx_tp2"),
    "vx_dp2": ("vx", DP2, None, {}, None),
    "vx_sp2": ("vx", dict(TP2, spatial_parallel=True), None, {}, None),
    "seq_dp2": ("seq", DP2, None, {}, None),
}


def _case_config(tmp, name):
    case, mesh, magno, dataset, _ = CASES[name]
    cfg = _config(tmp, case, name, magno=magno, **dataset)
    cfg["setup"].update(mesh)
    return cfg


@pytest.fixture(scope="module")
def jax_scans(tmp_path_factory):
    """``gaot_tpu``'s StaticTrainer on each JAX mesh and two epochs of its
    ``train_epoch_scan``: {case: (initial weights file, [2k] losses,
    weights after, initial weights)} by torch names."""
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    tmp = tmp_path_factory.mktemp("jax_scans")
    out = {}
    for name in ("fx_dp2", "fx_tp2"):
        jt = JStaticTrainer(_case_config(tmp, name))
        assert jt._mesh_size() == 2 and jt._scan_available()
        w0 = flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params))
        path = td.save_weights(w0, str(tmp / f"{name}.pt"))
        losses = np.concatenate([np.asarray(jt.train_epoch_scan()) for _ in range(2)])
        out[name] = (path, losses,
                     flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params)), w0)
    # With device_data off gaot_tpu places the loader's host buffers
    # replicated over its mesh and scans: the trajectory of its device
    # buffers' run above.
    host = JStaticTrainer(_case_config(tmp, "fx_dp2_host_batches"))
    assert host.train_loader.device_epoch_spec is None and host._scan_available()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_scans):
    """Every case of CASES on two ranks in one start: what each rank's
    ``torch_dist.epoch_and_per_step`` returned, by case."""
    tmp = tmp_path_factory.mktemp("ranks")
    calls = [("epoch_and_per_step",
              (_case_config(tmp, name), jax_scans[jax][0] if jax else None))
             for name, (*_, jax) in CASES.items()]
    res = td.run_ranks(td.several, 2, tmp, calls, timeout=400.0)
    return [dict(zip(CASES, r)) for r in res]


def _same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("name", list(CASES))
def test_epoch_path_on_two_ranks_matches_per_step(ranks, name):
    for rank, res in enumerate(ranks):
        got = res[name]
        assert got["route"] == ("epoch", "setup.device cpu: the step body uncaptured")
        assert got["device_buffers"] == (name != "fx_dp2_host_batches")
        e, s = got["epoch"], got["step"]
        assert e["updates"] == s["updates"] == len(e["losses"]) > 0
        assert e["losses"] == s["losses"], (rank, e["losses"], s["losses"])
        assert np.isfinite(e["losses"]).all()
        _same(e["weights"], s["weights"], (name, rank))
        assert torch.equal(e["rng"], s["rng"]), (name, rank)
    # Both ranks train one model: the same losses and full weights.
    assert ranks[0][name]["epoch"]["losses"] == ranks[1][name]["epoch"]["losses"]
    _same(ranks[0][name]["epoch"]["weights"], ranks[1][name]["epoch"]["weights"], name)
    if CASES[name][2]:
        # The drop drew: the generator moved.
        fresh = torch.Generator().manual_seed(0).get_state()
        assert not torch.equal(ranks[0][name]["epoch"]["rng"], fresh)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[-1]])
def test_epoch_path_on_two_ranks_matches_jax_scan(ranks, jax_scans, name):
    _, want, w_after, w0 = jax_scans[CASES[name][-1]]
    got = ranks[0][name]["epoch"]
    np.testing.assert_allclose(np.asarray(got["losses"], np.float32), want, rtol=1e-5)
    _close({k: v.numpy() for k, v in got["weights"].items()}, w_after, 1e-5, name,
           base=w0)
