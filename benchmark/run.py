#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gaot_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
and a traffic mix; the mix's mode (``modes/<mode>.py``) builds the
measured program in set-up, drives it for ``--seconds`` and then checks
what the window produced against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, read from a device trace of one
stretch of the window), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit (also the last
lines of standard error).

No card, fewer cards than the cell asks for, or ``jax``, ``jaxlib``,
``flax`` or ``gaot_tpu`` loaded in this process once the window has
closed: no result and a nonzero exit. Kernel builds stay in the
checkout (``gaot_torch/_build``); the data and the program's outputs go to
a folder of this run's own under ``TMPDIR``, removed at the end.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402

START = harness.process_start()


class Context:
    """What one run carries from set-up through the window to the check."""

    def __init__(self, **kw):
        self.marks = []
        self.__dict__.update(kw)

    def mark(self, name: str) -> None:
        """The end of a set-up phase, on the host's clock."""
        import time

        self.marks.append((name, time.perf_counter()))


def _cache_dirs() -> None:
    """Build caches at fixed folders inside the checkout (the kernels'
    own folder is ``gaot_torch/_build``)."""
    cache = os.path.join(harness.ROOT, ".cache", "benchmark")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def _card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, spec=None, device: str = "cuda", config=None, traffic=None, limits=None,
        start: float = None):
    """One run; returns (exit code, result line or None). ``device`` "cpu"
    (with ``config``, ``traffic`` and ``limits`` given) drives the same run
    on the CPU at a small size, for tests."""
    import shutil
    import time

    import torch

    spec = spec or harness.benchmark_spec()
    cell = harness.cell_spec(spec, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"the cell {cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"device_count {torch.cuda.device_count()}", file=sys.stderr)
            return 2, None
    config = config or harness.config_file(cell["config"])
    traffic = traffic or harness.traffic_file(cell["traffic"])
    limits = limits or harness.limits_file(cell["name"])
    mode = harness.mode_module(traffic["mode"])
    ctx = Context(cell=cell, config=config, traffic=traffic, device=device,
                  seconds=args.seconds, trace=bool(args.trace),
                  seeds=harness.seeds(args.seed), folder=None)
    try:
        mode.setup(ctx)
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - (START if start is None else start)
        last = START if start is None else start
        phases = []
        for name, t in ctx.marks:
            phases.append(f"{name} {t - last:.3f} s")
            last = t
        print(f"set-up {setup_s:.3f} s: " + ", ".join(phases), file=sys.stderr)
        e2e = mode.window(ctx)
        memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
        numbers = mode.check(ctx)
    finally:
        if ctx.folder:
            shutil.rmtree(ctx.folder, ignore_errors=True)
    checks = [(name, value, limits[name]) for name, value in numbers if name in limits]
    for name, value in numbers:
        if name not in limits:
            print(f"reading {name} = {value!r} (not compared in this cell)", file=sys.stderr)
    correct = ctx.failed == 0 and all(v <= lim for _, v, lim in checks)
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if args.trace:
        tr = ctx.readings.get("trace")
        if tr is None:
            raise RuntimeError("the traced run read no device trace")
        readings = dict(ctx.readings, setup_s=setup_s, window_s=ctx.window_s)
        metrics = {}
        for name, reader in harness.metric_readers(spec, cell["name"]).items():
            value = reader.read(readings)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {name: {"value": value, "unit": units[name]} for name, value in e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    if device == "cuda":
        print(f"card: {_card()}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of the JAX package or JAX loaded in this process: {found}",
              file=sys.stderr)
        return 3, None
    for name, value, lim in checks:
        print(f"check {name} = {value!r} (limit {lim!r}): "
              f"{'ok' if value <= lim else 'FAILED'}", file=sys.stderr)
    print(f"check failed steps or requests = {ctx.failed} of {ctx.attempted} (limit 0)",
          file=sys.stderr)
    return 0, harness.result_line(correct, ctx.attempted, ctx.failed, metrics, dev_info,
                                  checks + [("failed", ctx.failed, 0)], breakdown)


def main(argv=None) -> int:
    _cache_dirs()
    args = parse(sys.argv[1:] if argv is None else argv)
    rc, line = run(args)
    sys.stderr.flush()
    if line is not None:
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
