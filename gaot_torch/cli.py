"""Command-line entry point: ``python -m gaot_torch.cli -c config.json`` or
``-f config_folder/``.

Counterpart of ``gaot_tpu/cli.py`` (reference main.py:19-198): load one or
many JSON/TOML experiment configs, run the static or the sequential
trainer (``setup.trainer_name``), and append a result row to the
experiment CSV database. Relative output paths resolve against the config
file's folder.

A folder runs each config as a ``python -m gaot_torch.cli -c`` subprocess,
``--jobs`` at a time (default 1: one card); ``--debug`` runs them in this
process, one after another.
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import subprocess
import sys
import time
from typing import Dict

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_datarow(raw: Dict, config_path: str) -> Dict:
    """Flat experiment-database row (reference main.py:69-95)."""
    nan = float("nan")
    row = {
        "config": config_path,
        "time": time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()),
        "nparams": -1,
        "nbytes": -1,
        "training time": nan,
        "samples_per_sec": nan,
        "relative error (direct)": nan,
        "relative error (auto2)": nan,
        "relative error (auto4)": nan,
    }
    for section in ("setup", "model", "dataset", "optimizer"):
        row[section] = repr(raw.get(section, {}))
    return row


def _cell(v) -> str:
    """A value as pandas writes it: NaN as an empty cell."""
    if isinstance(v, float) and math.isnan(v):
        return ""
    return str(v)


def _append_csv(database_path: str, row: Dict) -> None:
    """Append ``row`` to the CSV database; columns new to the file are added
    with empty cells in the rows already there, and the row leaves the
    file's other columns empty (the JAX package's pandas semantics, so both
    CLIs can share one database)."""
    os.makedirs(os.path.dirname(database_path) or ".", exist_ok=True)
    header, rows = [], []
    if os.path.exists(database_path):
        with open(database_path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            rows = list(reader)
    header = header + [c for c in row if c not in header]
    rows = [r + [""] * (len(header) - len(r)) for r in rows]
    rows.append([_cell(row[c]) if c in row else "" for c in header])
    tmp = f"{database_path}.{os.getpid()}.tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)
    os.replace(tmp, database_path)


def load_run_config(config_path: str):
    """(the raw config, the merged GAOTConfig) of a config file, its
    relative output paths resolved against the file's folder."""
    from .core.config import GAOTConfig, load_config_file, merge_config

    raw = load_config_file(config_path)
    cfg = merge_config(GAOTConfig, raw)
    base = os.path.dirname(os.path.abspath(config_path))
    for attr in ("ckpt_path", "loss_path", "result_path", "database_path"):
        p = getattr(cfg.path, attr)
        if not os.path.isabs(p):
            setattr(cfg.path, attr, os.path.join(base, p))
    return raw, cfg


def make_trainer(cfg, datarow=None):
    """The static or the sequential trainer of ``cfg`` (``setup.trainer_name``)."""
    from .train import SequentialTrainer, StaticTrainer

    trainer_cls = (SequentialTrainer if cfg.setup.trainer_name == "sequential"
                   else StaticTrainer)
    return trainer_cls(cfg, datarow=datarow)


def run_config(config_path: str):
    """Train and/or test one config; returns the trainer."""
    raw, cfg = load_run_config(config_path)
    datarow = _make_datarow(raw, config_path)
    trainer = make_trainer(cfg, datarow)

    if cfg.setup.train:
        if cfg.setup.ckpt:
            trainer.load_ckpt()
        if cfg.setup.profile_dir:
            _profiled_fit(trainer, cfg.setup.profile_dir)
        else:
            trainer.fit()
    if cfg.setup.test:
        trainer.load_ckpt()
        trainer.test()
    if trainer.rank0:
        _append_csv(cfg.path.database_path, datarow)
    return trainer


def _profiled_fit(trainer, profile_dir: str) -> None:
    """``fit`` under torch.profiler; a Chrome trace in ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trainer.fit()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _collect_configs(folder: str):
    paths = []
    for root, _, files in os.walk(folder):
        for name in sorted(files):
            if name.endswith((".json", ".toml")):
                paths.append(os.path.join(root, name))
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gaot_torch experiment runner")
    parser.add_argument("-c", "--config", type=str, default=None,
                        help="config file path")
    parser.add_argument("-f", "--folder", type=str, default=None,
                        help="folder of config files")
    parser.add_argument("--debug", action="store_true",
                        help="run multi-config jobs in-process, serially")
    parser.add_argument("--jobs", type=int, default=1,
                        help="concurrent subprocesses for multi-config runs")
    args = parser.parse_args(argv)
    if not (args.config or args.folder):
        parser.error("specify --config or --folder")

    config_paths = [args.config] if args.config else _collect_configs(args.folder)
    if len(config_paths) == 1 or args.debug:
        import torch.distributed as dist

        joined = dist.is_initialized()
        for path in config_paths:
            run_config(path)
        if dist.is_initialized() and not joined:
            # A group the run joined (setup.distributed) is left here.
            dist.destroy_process_group()
        return 0

    # Subprocess pool, `--jobs` at a time (reference main.py:132-173).
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    pending = list(config_paths)
    failures = 0
    while pending:
        chunk, pending = pending[:args.jobs], pending[args.jobs:]
        procs = [subprocess.Popen([sys.executable, "-m", "gaot_torch.cli", "-c", p],
                                  env=env) for p in chunk]
        for p, path in zip(procs, chunk):
            if p.wait() != 0:
                print(f"Job {path} failed with code {p.returncode}", file=sys.stderr)
                failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
