"""Synthetic data at a configuration's layout, made from the seed.

No data file of the example recipes is at hand, so each configuration names
a layout (``data.layout`` in its file) and that layout's maker
(``layouts/<layout>.py``: ``make(rng, total, layout)``) makes every
split's samples from the seed, in bulk, as the recipe's reader expects
them (``u``, ``c`` [S, 1, N, ·] and ``x``); this module writes them as one
``.npz`` for the measured program to read, as it reads a dataset file. The
same arrays go to the plain reference, which normalises them itself.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))


def split_sizes(config: dict) -> Dict[str, int]:
    ds = config["dataset"]
    return {"train": ds["train_size"], "val": ds["val_size"], "test": ds["test_size"]}


def make(layout: dict, total: int, seed: int) -> Dict[str, np.ndarray]:
    """``total`` samples of ``layout`` from ``seed``: u, c [S, 1, N, ·] and
    x ([1, 1, N, d] for one point cloud, else [S, 1, N, d]), float32."""
    path = os.path.join(HERE, "layouts", f"{layout['layout']}.py")
    if not os.path.exists(path):
        raise ValueError(f"unknown data layout {layout['layout']!r}: no {path}")
    maker = harness.load_module(path, f"bench_layout_{layout['layout']}")
    return maker.make(np.random.default_rng(seed), total, layout)


def write(arrays: Dict[str, np.ndarray], folder: str, name: str) -> str:
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{name}.npz")
    np.savez(path, **arrays)
    return path
