"""The port's vx pipeline and static trainer (a mesh per sample) on the CPU.

- Pipeline, bit for bit against the JAX package: the stacked degree
  bucketizer and the stacked in-degree grouping, ``build_vx_split`` +
  ``bucketize_vx_splits`` + ``attach_transpose_graphs`` (through
  ``build_all_vx_graphs``, Morton-ordered, one and two scales, bucketed and
  dense), ``vx_graph_buffers`` and its inverse, and the vx loader's batches
  (the Morton permutation of u and c, node padding, ``node_mask``), over
  shuffled epochs, from the host and from buffers on the device.
- Trainer: both packages' StaticTrainers on ``tests/synthetic.py::
  make_static_vx_dataset`` (96 nodes a sample padded to 128), the port
  given JAX's initial parameters: the loss records within rtol 2e-4, the
  relative error (padded nodes filled with the global mean on both sides)
  within rtol 1e-3, each restored parameter within 1e-3 of its largest
  entry, as ``tests/test_torch_trainer.py`` holds fx.
- CLI: ``config/examples/time_indep/elasticity.json`` read from disk trains
  through ``python -m gaot_torch.cli -c`` on the CPU, on synthetic data at
  the Elasticity layout (``tests/torch_synthetic.py``), with the sample
  counts, the epochs and, for the CPU's time, the latent grid and the
  UViT width cut.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_static_vx_dataset  # noqa: E402
from test_train_e2e import TINY_MODEL, TINY_OPT, _paths  # noqa: E402
from torch_synthetic import make_elasticity_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lattice(n):
    ax = np.linspace(-1, 1, n)
    return np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)


def _splits(seed=0, n=(120, 104, 97)):
    """Three splits whose samples have different node counts (padded to
    one N by the build)."""
    rng = np.random.default_rng(seed)
    return {name: {"x": rng.uniform(-1, 1, (s, m, 2)).astype(np.float32)}
            for name, s, m in zip(("train", "val", "test"), (5, 2, 3), n)}


def _assert_buffers_equal(a, b):
    assert a.keys() == b.keys(), a.keys() ^ b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_stacked_layouts_bitwise():
    """bucketize_graphs_stacked, degree_group_tgraph on a stacked transpose
    graph, stack_graphs / repad / stack_tgraphs / repad_tgraph, morton_order
    and padded_from_search, against the JAX package's."""
    from gaot_torch.ops import padding as tpad
    from gaot_torch.ops.neighbor_search import radius_search
    from gaot_tpu.ops import padding as jpad

    rng = np.random.default_rng(1)
    lat = _lattice(10)
    xs = rng.uniform(-1, 1, (4, 150, 2))
    for i in range(4):
        np.testing.assert_array_equal(tpad.morton_order(xs[i]), jpad.morton_order(xs[i]))
    csrs = [radius_search(xs[i], lat, 0.35) for i in range(4)]
    tg = [tpad.pad_csr(*c) for c in csrs]
    jg = [jpad.pad_csr(*c) for c in csrs]
    d = {"neighbors_index": csrs[0][0], "neighbors_row_splits": csrs[0][1]}
    np.testing.assert_array_equal(tpad.padded_from_search(d, k=5).indices,
                                  jpad.padded_from_search(d, k=5).indices)
    ts, js = tpad.stack_graphs(tg), jpad.stack_graphs(jg)
    _assert_buffers_equal(ts._asdict(), js._asdict())
    for k in (3, ts.k + 4):
        _assert_buffers_equal(tpad.repad(ts, k)._asdict(), jpad.repad(js, k)._asdict())
    tt = tpad.stack_tgraphs([tpad.transpose_graph(g, 150) for g in tg])
    jt = jpad.stack_tgraphs([jpad.transpose_graph(g, 150) for g in jg])
    _assert_buffers_equal(tt._asdict(), jt._asdict())
    for kt in (2, tt.kt + 3):
        _assert_buffers_equal(tpad.repad_tgraph(tt, kt)._asdict(),
                              jpad.repad_tgraph(jt, kt)._asdict())
    tgr, jgr = tpad.degree_group_tgraph(tt), jpad.degree_group_tgraph(jt)
    np.testing.assert_array_equal(tgr.inv_perm, jgr.inv_perm)
    assert len(tgr.groups) == len(jgr.groups) > 1
    for a, b in zip(tgr.groups, jgr.groups):
        _assert_buffers_equal(a._asdict(), b._asdict())
    tb = tpad.bucketize_graphs_stacked(ts, 150, min_k=6)
    jb = jpad.bucketize_graphs_stacked(js, 150, min_k=6)
    assert tb is not None and len(tb.buckets) > 1
    assert tb.bucket_ks == jb.bucket_ks and tb.bucket_rows == jb.bucket_rows
    for name in ("perm", "inv_perm", "row_valid"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    for a, b in zip(tb.buckets, jb.buckets):
        _assert_buffers_equal(a._asdict(), b._asdict())
    _assert_buffers_equal(tb.tgraph._asdict(), jb.tgraph._asdict())


@pytest.mark.parametrize("scales", [[1.0], [1.0, 1.5]], ids=["one_scale", "two_scales"])
@pytest.mark.parametrize("bucketing", [True, False], ids=["bucketed", "dense"])
def test_vx_graph_build_bitwise(bucketing, scales):
    """build_all_vx_graphs (build_vx_split, the joint bucketing and grouping)
    and vx_graph_buffers, every split, and the buffers' round trip."""
    from gaot_torch.data import graph_builder as tgb
    from gaot_tpu.data import graph_builder as jgb

    splits, lat = _splits(), _lattice(9)
    out = {}
    for side, gb in (("jax", jgb), ("torch", tgb)):
        out[side] = gb.GraphBuilder(morton=True).build_all_vx_graphs(
            splits, lat, 0.3, scales, with_transpose=True, bucketing=bucketing)
    for name in ("train", "val", "test"):
        tb = tgb.vx_graph_buffers(out["torch"][name])
        _assert_buffers_equal(tb, jgb.vx_graph_buffers(out["jax"][name]))
        assert out["torch"][name].coords.shape[1] == 128          # 120 → N_pad
        back = tgb.vx_split_from_buffers(tb, len(scales))
        _assert_buffers_equal(tgb.vx_graph_buffers(back), tb)
    kinds = {type(g).__name__ for g in out["torch"]["train"].encoder}
    assert kinds == {"BatchedBucketedGraph" if bucketing else "PaddedGraph"}


@pytest.mark.parametrize("device_data", [True, False], ids=["device", "host"])
def test_vx_loader_batches_bitwise(device_data):
    """make_static_vx_loader against the JAX package's: u and c in the
    graphs' Morton order, padded to N_pad, every graph buffer, the node and
    sample masks, over three shuffled epochs of a batch size that does
    not divide the split."""
    from gaot_torch.data import graph_builder as tgb
    from gaot_torch.data.loader import make_static_vx_loader
    from gaot_tpu.data import graph_builder as jgb
    from gaot_tpu.data.loader import make_static_vx_loader as jloader

    splits, lat = _splits(2), _lattice(9)
    rng = np.random.default_rng(3)
    x = splits["train"]["x"]
    u = rng.normal(size=(*x.shape[:2], 2)).astype(np.float32)
    c = rng.normal(size=(*x.shape[:2], 3)).astype(np.float32)
    graphs = {side: gb.GraphBuilder(morton=True).build_all_vx_graphs(
        splits, lat, 0.3, [1.0], with_transpose=True, bucketing=True)["train"]
        for side, gb in (("jax", jgb), ("torch", tgb))}
    tl = make_static_vx_loader(c, u, graphs["torch"], 2, shuffle=True, seed=4,
                               device_data=device_data, device="cpu")
    jl = jloader(c, u, graphs["jax"], 2, shuffle=True, seed=4)
    assert len(tl) == len(jl) == 3
    perm = graphs["torch"].node_perm
    for _ in range(3):
        for tb, jb in zip(tl, jl):
            tb = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in tb.items()}
            # Beside the samples' buffers, each batch carries its layout.
            layout = tgb.vx_layout(tb, 2)
            assert layout.keys() == tb.keys() - jb.keys()
            _assert_buffers_equal({k: tb[k] for k in layout}, layout)
            _assert_buffers_equal({k: tb[k] for k in jb}, jb)
            nm = tb["node_mask"]
            assert not tb["u"][~nm].any() and not tb["c"][~nm].any()
    # The Morton order: u and c follow the nodes the graphs were built on.
    batch = next(iter(make_static_vx_loader(c, u, graphs["torch"], 5,
                                            device="cpu")))
    np.testing.assert_array_equal(batch["u"][:, :u.shape[1]].numpy(),
                                  u[np.arange(5)[:, None], perm])


def _vx_config(tmp_path, name):
    return {"setup": {"seed": 0, "trainer_name": "static", "train": True,
                      "device": "cpu"},
            "model": copy.deepcopy(TINY_MODEL),
            "dataset": {"name": "airfoil_toy", "metaname": "compressible_flow/naca0012",
                        "base_path": str(tmp_path), "train_size": 8, "val_size": 2,
                        "test_size": 2, "batch_size": 4, "shuffle": True},
            "optimizer": copy.deepcopy(TINY_OPT), "path": _paths(tmp_path, name)}


def test_vx_fit_matches_jax(tmp_path):
    """The counterpart of tests/test_train_e2e.py::
    test_static_trainer_vx_end_to_end, held against JAX's fit."""
    import jax

    from gaot_torch.train import StaticTrainer
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, load_flax_params
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    make_static_vx_dataset(str(tmp_path / "airfoil_toy.npz"))
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jt = JStaticTrainer({**_vx_config(tmp_path, "toy"),
                         "path": _paths(tmp_path / "jax", "toy")})
    pt = StaticTrainer({**_vx_config(tmp_path, "toy"),
                        "path": _paths(tmp_path / "torch", "toy")})
    assert jt.coord_mode == pt.coord_mode == "vx"
    load_flax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    assert pt.datarow["nparams"] == jt.datarow["nparams"]
    batch = next(iter(pt.test_loader))
    assert batch["x"].shape[1] == 128 and not batch["node_mask"][:, 96:].any()

    jt.fit(verbose=False)
    pt.fit(verbose=False)
    got = np.load(tmp_path / "torch" / "toy_loss.npz")
    want = np.load(tmp_path / "jax" / "toy_loss.npz")
    np.testing.assert_array_equal(got["epochs"], want["epochs"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(got["val_losses"], want["val_losses"], rtol=2e-4)
    err = pt.datarow["relative error (direct)"]
    assert np.isfinite(err) and err > 0
    np.testing.assert_allclose(err, jt.datarow["relative error (direct)"], rtol=1e-3)
    ref = flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params))
    ours = pt.model.state_dict()
    assert ref.keys() == ours.keys()
    for k, w in ref.items():
        assert np.abs(ours[k].numpy() - w).max() <= 1e-3 * np.abs(w).max(), k
    assert pt.step == len(pt.train_loader) * TINY_OPT["args"]["epoch"]


def elasticity_cpu_config(folder: str) -> str:
    """config/examples/time_indep/elasticity.json, read from disk, set to
    the CPU with its data in ``folder`` (synthetic, 972 points a sample),
    cut to 8 / 2 / 2 samples, 4 epochs, a 16x16 latent grid (radius
    0.033 → 0.14 to keep about the example's neighbours per latent
    point) and a UViT at hidden 64. Returns the written config's path."""
    with open(os.path.join(ROOT, "config", "examples", "time_indep",
                           "elasticity.json")) as f:
        raw = json.load(f)
    raw["setup"]["device"] = "cpu"
    raw["dataset"].update(base_path=folder, train_size=8, val_size=2, test_size=2)
    raw["optimizer"]["args"].update(epoch=4, eval_every_eps=2)
    raw["model"]["latent_tokens_size"] = [16, 16]
    raw["model"]["args"]["magno"]["radius"] = 0.14
    raw["model"]["args"]["transformer"]["hidden_size"] = 64
    raw["path"] = {k: os.path.join("out", k.split("_")[0], os.path.basename(v))
                   for k, v in raw["path"].items()}
    make_elasticity_dataset(os.path.join(folder, f"{raw['dataset']['name']}.npz"),
                            num_samples=12)
    path = os.path.join(folder, "elasticity.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def test_elasticity_trains_through_the_cli(tmp_path):
    cfg = elasticity_cpu_config(str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "gaot_torch.cli", "-c", cfg],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "agno=vx:plain" in out.stdout
    rec = np.load(tmp_path / "out" / "loss" / "elasticity.npz")
    assert rec["losses"][-1] < rec["losses"][0]
    with open(tmp_path / "out" / "database" / "elasticity.csv") as f:
        rows = f.read().splitlines()
    assert len(rows) == 2
    assert (tmp_path / "out" / "ckpt" / "elasticity.pt").exists()
    metric = float(out.stdout.split("Relative error:")[1].split()[0])
    assert np.isfinite(metric) and metric > 0
