"""gaot_torch stands alone: no module of it (nor chip_smoke.py, nor
kernel_ab.py) imports JAX, Flax, Optax or gaot_tpu; it imports with JAX
blocked, and imports and trains through its CLI with the host libraries
the card's machine lacks (matplotlib, pandas, h5py) blocked too; and its
entry points ask for the CUDA device unless told otherwise. A vx config
(the elasticity example) trains with JAX blocked, and a sequential one
(the ns_gauss example) with JAX and the host libraries blocked."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "gaot_tpu"}


def _sources():
    return sorted((ROOT / "gaot_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                           ROOT / "kernel_ab.py"]


def test_sources_cover_parallel_and_tools():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for m in ("parallel/__init__.py", "parallel/mesh.py", "parallel/comm.py",
              "parallel/spatial.py", "tools/import_torch_ckpt.py",
              "tools/export_torch_ckpt.py"):
        assert f"gaot_torch/{m}" in names, m


def test_sources_cover_the_epoch_path():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    assert "gaot_torch/train/graphed.py" in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, f"{path}: imports {name}"


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'gaot_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, gaot_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(gaot_torch.__path__,"
        " 'gaot_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'gaot_torch.models.gaot' in mods\n"
        "for m in ('parallel', 'parallel.mesh', 'parallel.comm', 'parallel.spatial',\n"
        "          'tools',\n"
        "          'tools.import_torch_ckpt', 'tools.export_torch_ckpt'):\n"
        "    assert 'gaot_torch.' + m in mods, m\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_trains_without_host_libraries(tmp_path):
    """With JAX, matplotlib, pandas and h5py blocked, every module imports
    and a tiny CPU config trains through ``gaot_torch.cli.main``, writing
    its loss record and its CSV row (and no PNG)."""
    import json

    sys.path.insert(0, str(ROOT / "tests"))
    from synthetic import make_static_fx_dataset
    from test_train_e2e import TINY_MODEL, TINY_OPT

    make_static_fx_dataset(str(tmp_path / "toy.npz"))
    cfg = {"setup": {"seed": 0, "device": "cpu"}, "model": TINY_MODEL,
           "dataset": {"name": "toy", "metaname": "elliptic_pdes/Poisson-Gauss",
                       "base_path": str(tmp_path), "train_size": 8,
                       "val_size": 2, "test_size": 2, "batch_size": 4},
           "optimizer": {**TINY_OPT, "args": {**TINY_OPT["args"], "epoch": 2}},
           "path": {"ckpt_path": "out/ckpt", "loss_path": "out/loss.png",
                    "result_path": "out/result.png", "database_path": "out/db.csv"}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'gaot_tpu', 'matplotlib',\n"
        "          'pandas', 'h5py'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, gaot_torch\n"
        "for m in pkgutil.walk_packages(gaot_torch.__path__, 'gaot_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from gaot_torch.cli import main\n"
        f"sys.exit(main(['-c', {str(tmp_path / 'cfg.json')!r}]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no result plot" in out.stdout
    assert (tmp_path / "out" / "loss.npz").exists()
    assert (tmp_path / "out" / "db.csv").exists()
    assert (tmp_path / "out" / "ckpt.pt").exists()
    assert not (tmp_path / "out" / "loss.png").exists()


def test_trains_vx_without_jax(tmp_path):
    """With JAX and gaot_tpu blocked, every module (the vx pipeline, model
    and trainer among them) imports and the elasticity example, a mesh per
    sample, trains on the CPU through ``gaot_torch.cli.main``."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_vx_trainer import elasticity_cpu_config

    cfg = elasticity_cpu_config(str(tmp_path))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'gaot_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, gaot_torch\n"
        "for m in pkgutil.walk_packages(gaot_torch.__path__, 'gaot_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from gaot_torch.cli import main\n"
        f"sys.exit(main(['-c', {cfg!r}]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "agno=vx:plain" in out.stdout
    assert (tmp_path / "out" / "database" / "elasticity.csv").exists()
    assert (tmp_path / "out" / "ckpt" / "elasticity.pt").exists()


def test_trains_sequential_without_host_libraries(tmp_path):
    """With JAX, matplotlib, pandas and h5py blocked, the ns_gauss example
    (cut for the CPU as tests/test_torch_seq_cli.py cuts it) trains and
    rolls out through ``gaot_torch.cli.main``: its loss record, its CSV row
    with the three rollout errors, its checkpoint, and no plot."""
    import csv

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_seq_cli import example_cpu_config

    cfg = example_cpu_config(str(tmp_path), "ns_gauss")
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'gaot_tpu', 'matplotlib',\n"
        "          'pandas', 'h5py'):\n"
        "    sys.modules[m] = None\n"
        "from gaot_torch.cli import main\n"
        f"sys.exit(main(['-c', {cfg!r}]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no result plot or animation" in out.stdout
    with open(tmp_path / "out" / "database" / "ns_gauss.csv") as f:
        row = next(csv.DictReader(f))
    for key in ("direct", "auto2", "auto4"):
        assert float(row[f"relative error ({key})"]) > 0
    assert (tmp_path / "out" / "loss" / "ns_gauss.npz").exists()
    assert (tmp_path / "out" / "ckpt" / "ns_gauss.pt").exists()
    assert not list((tmp_path / "out").rglob("*.png"))


def test_entry_points_default_to_cuda():
    import numpy as np

    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.data.graph_builder import GraphBuilder, prepare_fx_device_graphs
    from gaot_torch.models import GAOT

    cfg = merge_config(ModelConfig, {
        "latent_tokens_size": [4, 4],
        "args": {"magno": {"hidden_size": 8, "lifting_channels": 4},
                 "transformer": {"patch_size": 2, "hidden_size": 16,
                                 "num_layers": 1}}})
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (20, 2)).astype(np.float32)
    lat = rng.uniform(-1, 1, (16, 2)).astype(np.float32)
    enc, dec = GraphBuilder().build_fx_graphs(coords, lat, 0.5, [1.0])
    if torch.cuda.is_available():
        assert next(GAOT(1, 1, cfg).parameters()).is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError)):
        GAOT(1, 1, cfg)
    with pytest.raises((AssertionError, RuntimeError)):
        prepare_fx_device_graphs(enc, dec, 20, 16, cfg.args.magno)
