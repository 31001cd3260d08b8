#!/usr/bin/env python3
"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--seconds 2] [--out FILE]

In one process, for each seed: a run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the check), printing the numbers its
check compares (the lower readings); then for each control seed the same
numbers with the plain reference in TF32 put in the program's place (the
upper readings). One JSON object a line, also appended to ``--out``.
Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402
from benchmark.run import Context  # noqa: E402


def control_context(cell: dict, seed: int, device: str = "cuda") -> Context:
    """What the control needs of a run: the data and the weights of
    ``seed`` (no measured program)."""
    from benchmark import data
    from benchmark.reference import model as ref_model

    config = harness.config_file(cell["config"])
    traffic = harness.traffic_file(cell["traffic"])
    ctx = Context(cell=cell, config=config, traffic=traffic, device=device,
                  seeds=harness.seeds(seed), folder=None)
    ctx.arrays = data.make(config["data"], sum(data.split_sizes(config["config"]).values()),
                           ctx.seeds["data"])
    a = ctx.arrays
    shapes = ref_model.Shapes(config["config"]["model"], a["c"].shape[-1], a["u"].shape[-1])
    w = ref_model.init_weights(shapes, ctx.seeds["weights"], device)
    ctx.w0 = {k: v.cpu() for k, v in w.items()}
    if traffic["mode"] == "infer":
        ctx.pool_rows = harness.mode_module("infer").pool_rows(ctx)
    return ctx


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import shutil

    import torch

    spec = harness.benchmark_spec()
    cell = harness.cell_spec(spec, args.workload)
    config = harness.config_file(cell["config"])
    traffic = harness.traffic_file(cell["traffic"])
    mode = harness.mode_module(traffic["mode"])

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds:
        ctx = Context(cell=cell, config=config, traffic=traffic, device="cuda",
                      seconds=args.seconds, trace=False, seeds=harness.seeds(seed),
                      folder=None)
        t0 = time.perf_counter()
        try:
            mode.setup(ctx)
            mode.window(ctx)
            numbers = mode.check(ctx)
        finally:
            if ctx.folder:
                shutil.rmtree(ctx.folder, ignore_errors=True)
        emit({"cell": cell["name"], "kind": "program", "seed": seed,
              "failed": ctx.failed, "numbers": dict(numbers),
              "detail": (mode.detail(ctx.leaves) if hasattr(mode, "detail") else None),
              "seconds": time.perf_counter() - t0})
        del ctx
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        ctx = control_context(cell, seed)
        rec = {"cell": cell["name"], "kind": "control", "seed": seed,
               "numbers": dict(mode.control(ctx))}
        if hasattr(mode, "faults"):
            rec["faults"] = {k: dict(v) for k, v in mode.faults(ctx).items()}
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        del ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
