"""The Poisson-Gauss layout: one point cloud of ``nodes`` points uniform in
the unit square for every sample, a source field ``c`` normal per node,
the response ``u`` a smooth map of ``c`` and the position
(``tests/synthetic.py``'s map)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def make(rng, total: int, layout: dict) -> Dict[str, np.ndarray]:
    nodes = layout["nodes"]
    coords = rng.uniform(0, 1, (nodes, 2))
    c = rng.standard_normal((total, 1, nodes, 1), dtype=np.float32)
    sx = np.sin(2 * np.pi * coords[:, 0]).astype(np.float32)[None, None, :, None]
    cy = np.cos(2 * np.pi * coords[:, 1]).astype(np.float32)[None, None, :, None]
    u = 0.5 * c + 0.3 * sx + 0.2 * c * cy
    return {"u": u.astype(np.float32), "c": c,
            "x": coords[None, None].astype(np.float32)}
