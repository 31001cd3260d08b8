"""What ``benchmark/run.py`` loads for every cell has no module of JAX or of
the JAX package (top-level names compared whole: the port's name begins with
the JAX package's), and the plain reference imports nothing of the measured
program."""
import ast
import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT

LOAD_EVERY_CELL = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness, run
spec = harness.benchmark_spec()
for cell in spec["workloads"]:
    harness.config_file(cell["config"])
    traffic = harness.traffic_file(cell["traffic"])
    harness.mode_module(traffic["mode"])
    harness.limits_file(cell["name"])
    harness.metric_readers(spec, cell["name"])
import gaot_torch.train.static_trainer, gaot_torch.train.graphed  # what the modes build
import gaot_torch.ops.cuda.flash_attention, gaot_torch.ops.cuda.multiply_reduce
import gaot_torch.ops.cuda.fused_ffn
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_no_jax_in_what_a_run_loads():
    out = subprocess.run([sys.executable, "-c", LOAD_EVERY_CELL.format(root=ROOT)],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gaot_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            tops = {m.split(".", 1)[0] for m in _imports(os.path.join(folder, name))}
            assert not tops & {"gaot_torch", "gaot_tpu", "jax", "jaxlib", "flax"}, name
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import benchmark.reference.model, benchmark.reference.train, "
            "benchmark.reference.graphs, benchmark.reference.precision; "
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert "gaot_torch" not in out.stdout and "gaot_tpu" not in out.stdout


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("gaot_torch", __import__("gaot_torch"))
    assert "gaot_torch" not in harness.forbidden_modules()
