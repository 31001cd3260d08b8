"""The on-disk vx graph cache (``dataset.graph_cache_dir``) shared by the
port and the JAX package, on the CPU.

- Builders: a cache that ``gaot_tpu``'s ``build_all_vx_graphs_cached``
  writes loads in the port (``gaot_torch/data/graph_builder.py::
  GraphBuilder.build_all_vx_graphs_cached``) to the same buffers bit for
  bit, under the same file name, and one the port writes loads in
  ``gaot_tpu`` the same way; with and without degree buckets and transpose
  graphs.
- Trainers: the static and the sequential trainer build through the cache,
  and a second construction hits it; the file is named as the JAX
  trainer names it (``{name}-{coord_scaling}``, the sequential trainer's
  with ``-seq``) and holds the same arrays.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_sequential_vx_dataset, make_static_vx_dataset  # noqa: E402
from test_torch_seq_trainer import _config as _seq_config  # noqa: E402
from test_torch_sequential import VX_META, vx_metadata  # noqa: E402
from test_torch_vx_trainer import _vx_config  # noqa: E402
from test_train_e2e import _paths  # noqa: E402

# (with_transpose, bucketing)
LAYOUTS = {"bucketed_tgraphs": (True, True), "bucketed": (False, True),
           "dense_tgraphs": (True, False)}


def _splits():
    rng = np.random.default_rng(4)
    return {name: {"x": rng.uniform(-1, 1, (n, 70, 2)).astype(np.float32)}
            for name, n in (("train", 4), ("val", 2), ("test", 2))}


def _lattice(n=8):
    ax = np.linspace(-1, 1, n)
    return np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)


def _build(pkg, cache_dir, layout, capsys):
    """(the splits' buffers, the cache file, whether it was a hit)."""
    import importlib

    gb = importlib.import_module(f"{pkg}.data.graph_builder")
    with_transpose, bucketing = LAYOUTS[layout]
    builder = gb.GraphBuilder(morton=True, pad_multiple=4)
    out = builder.build_all_vx_graphs_cached(
        str(cache_dir), "toy-global_scaling", _splits(), _lattice(), 0.3, [1.0, 1.6],
        with_transpose=with_transpose, bucketing=bucketing)
    said = capsys.readouterr().out
    files = list(cache_dir.glob("*.npz"))
    assert len(files) == 1
    return ({s: gb.vx_graph_buffers(g) for s, g in out.items() if g is not None},
            files[0], "Graph cache hit" in said)


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for split in want:
        assert got[split].keys() == want[split].keys(), split
        for k, w in want[split].items():
            g = np.asarray(got[split][k])
            assert g.dtype == w.dtype and g.shape == w.shape, (split, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{split}::{k}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("writer, reader", [("gaot_tpu", "gaot_torch"),
                                            ("gaot_torch", "gaot_tpu")],
                         ids=["jax_writes", "port_writes"])
def test_cache_loads_in_the_other_package(tmp_path, capsys, layout, writer, reader):
    built, path, hit = _build(writer, tmp_path, layout, capsys)
    assert not hit
    loaded, path_read, hit = _build(reader, tmp_path, layout, capsys)
    assert hit and path_read == path
    _assert_equal(loaded, built)
    with np.load(path) as z:
        _assert_equal({s: {k.split("::", 1)[1]: z[k] for k in z.files
                           if k.startswith(f"{s}::")} for s in built}, built)
    # The other package, writing the same build afresh, names the file
    # alike and writes the same arrays.
    (tmp_path / "fresh").mkdir()
    fresh, path_fresh, _ = _build(reader, tmp_path / "fresh", layout, capsys)
    assert path_fresh.name == path.name
    _assert_equal(fresh, built)


def _npz(path):
    with np.load(path) as z:
        return {"all": {k: z[k] for k in z.files}}


def _trainer_cache(tmp_path, capsys, make, cls, name):
    """The cache file of two constructions of ``cls`` (``make(cache_dir,
    path_dir)`` gives the config), the second a hit with the same first
    test batch."""
    def build(tag):
        trainer = cls(make(str(tmp_path / "cache"), tmp_path / tag))
        return trainer, capsys.readouterr().out

    first, said = build("one")
    assert "Graph cache hit" not in said
    second, said = build("two")
    assert "Graph cache hit" in said
    (path,) = (tmp_path / "cache").glob("*.npz")
    assert path.name.startswith(f"graphs_{name}_")
    b1, b2 = next(iter(first.test_loader)), next(iter(second.test_loader))
    assert b1.keys() == b2.keys()
    for k in b1:
        np.testing.assert_array_equal(np.asarray(b1[k]), np.asarray(b2[k]), err_msg=k)
    return path


def test_static_trainer_hits_the_cache(tmp_path, capsys):
    from gaot_torch.train import StaticTrainer
    from gaot_tpu.train import StaticTrainer as JStaticTrainer

    make_static_vx_dataset(str(tmp_path / "airfoil_toy.npz"))

    def make(cache, out):
        out.mkdir(exist_ok=True)
        cfg = _vx_config(tmp_path, "toy")
        cfg["dataset"]["graph_cache_dir"] = cache
        cfg["path"] = _paths(out, "toy")
        return cfg

    path = _trainer_cache(tmp_path, capsys, make, StaticTrainer,
                          "airfoil_toy-per_dim_scaling")
    JStaticTrainer(make(str(tmp_path / "jax_cache"), tmp_path / "jax"))
    (jpath,) = (tmp_path / "jax_cache").glob("*.npz")
    assert jpath.name == path.name
    _assert_equal(_npz(path), _npz(jpath))


def test_sequential_trainer_hits_the_cache(tmp_path, capsys):
    from gaot_torch.train import SequentialTrainer
    from gaot_tpu.train import SequentialTrainer as JSequentialTrainer

    make_sequential_vx_dataset(str(tmp_path / "seq_vx_toy.npz"))
    ds = {"name": "seq_vx_toy", "metaname": VX_META, "train_size": 6, "val_size": 2,
          "test_size": 2, "batch_size": 8, "stepper_mode": "output"}

    def make(cache, out):
        out.mkdir(exist_ok=True)
        cfg = _seq_config(tmp_path, "toy", dict(ds, graph_cache_dir=cache))
        cfg["path"] = _paths(out, "toy")
        return cfg

    with vx_metadata():
        path = _trainer_cache(tmp_path, capsys, make, SequentialTrainer,
                              "seq_vx_toy-per_dim_scaling-seq")
        JSequentialTrainer(make(str(tmp_path / "jax_cache"), tmp_path / "jax"))
    (jpath,) = (tmp_path / "jax_cache").glob("*.npz")
    assert jpath.name == path.name
    _assert_equal(_npz(path), _npz(jpath))
