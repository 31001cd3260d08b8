"""The benchmark's general machinery: the cell's files found by name, the
measured program built from a configuration, the readers of per-layer
metrics, the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; everything else is found by those names:

- ``configs/<config>.json``: the recipe as run (``config``), its data
  layout (``data``), its dtype, what was assumed and cut;
- ``traffic/<traffic>.json``: the mix's parameters, among them ``mode``,
  the driver that runs it (``modes/<mode>.py``: ``setup``, ``window``,
  ``check``);
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares;
- ``metrics/<metric>.py``: one reader a per-layer metric, holding
  ``LAYER``, ``UNIT``, ``MOVES``, ``SOURCE`` and ``read(readings)``, which
  returns the metric's value or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gaot_tpu")


def process_start() -> float:
    """perf_counter() at this process's start (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_module(path: str, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def config_file(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits_file(cell: str) -> dict:
    return load_json(os.path.join(HERE, "limits", f"{cell}.json"))


def mode_module(mode: str) -> ModuleType:
    return load_module(os.path.join(HERE, "modes", f"{mode}.py"), f"bench_mode_{mode}")


def metric_readers(spec: dict, cell: str) -> Dict[str, ModuleType]:
    """The readers of the per-layer metrics that report in ``cell``: those
    whose ``workloads`` name it, or that have no ``workloads`` key."""
    folder = os.path.join(HERE, "metrics")
    out = {}
    for m in spec["per_layer"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out[m["name"]] = load_module(os.path.join(folder, f"{m['name']}.py"),
                                     "bench_metric_" + m["name"].replace(".", "_"))
    return out


def seeds(seed: int) -> Dict[str, int]:
    """Named seeds of the run, each under 2**31, derived from ``seed``
    (any whole number)."""
    state = np.random.SeedSequence(abs(int(seed)) + (1 << 64 if seed < 0 else 0))
    vals = state.generate_state(4, dtype=np.uint32) >> 1
    return {"data": int(vals[0]), "program": int(vals[1]), "weights": int(vals[2]),
            "traffic": int(vals[3])}


def scratch_dir() -> str:
    """A folder of this run's own under the temporary directory."""
    return tempfile.mkdtemp(prefix="gaot_bench_")


def program_config(cfg: dict, seed: int, folder: str, device: str) -> dict:
    """The recipe as the measured program runs it: the configuration's
    ``config`` with the run's seed, its device and its data and output
    paths under ``folder``."""
    raw = json.loads(json.dumps(cfg["config"]))
    raw.setdefault("setup", {})
    raw["setup"].update(seed=seed, device=device)
    raw["dataset"]["base_path"] = folder
    raw["path"] = {k: os.path.join(folder, "out", k) for k in
                   ("ckpt_path", "loss_path", "result_path", "database_path")}
    return raw


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile (nearest rank) of ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: List[tuple], breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)
