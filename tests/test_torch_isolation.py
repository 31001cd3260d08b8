"""gaot_torch stands alone: no module of it (nor chip_smoke.py) imports JAX,
Flax, Optax or gaot_tpu; it imports with JAX blocked; and its entry points
ask for the CUDA device unless told otherwise."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "gaot_tpu"}


def _sources():
    return sorted((ROOT / "gaot_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


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
