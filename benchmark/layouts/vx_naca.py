"""The airfoil layout: a mesh per sample of ``nodes`` points around a NACA
0012 profile (the public 4-digit thickness formula) turned by the
sample's angle of attack in [-5, 5] degrees about its quarter chord,
``wall_share`` of the points in an exponential boundary layer over the
profile at cosine-spaced chord positions, the rest uniform in the domain
[-1, 2.5] x [-1.5, 2] outside the profile; ``c`` holds the wall distance
and the angle's cosine and sine, ``u`` a smooth field of them
(``tests/torch_synthetic.py``'s layout)."""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


def naca0012_thickness(x: np.ndarray) -> np.ndarray:
    """Half thickness of the NACA 0012 profile at chord positions x in [0, 1]."""
    return 5 * 0.12 * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x ** 2
                       + 0.2843 * x ** 3 - 0.1015 * x ** 4)


def make(rng, total: int, layout: dict) -> Dict[str, np.ndarray]:
    nodes = layout["nodes"]
    wall_share, layer = layout.get("wall_share", 0.4), layout.get("layer", 0.02)
    lo, hi = np.array([-1.0, -1.5]), np.array([2.5, 2.0])
    n_wall = int(round(wall_share * nodes))
    n_far = nodes - n_wall
    alpha = np.deg2rad(rng.uniform(-5.0, 5.0, total))
    ca, sa = np.cos(alpha), np.sin(alpha)
    rot = np.stack([np.stack([ca, -sa], -1), np.stack([sa, ca], -1)], -2)  # [S, 2, 2]
    quarter = np.array([0.25, 0.0])
    # Boundary layer, in the profile's frame.
    xc = 0.5 * (1.0 - np.cos(np.pi * rng.uniform(0, 1, (total, n_wall))))
    side = rng.choice([-1.0, 1.0], (total, n_wall))
    d_wall = rng.exponential(layer, (total, n_wall))
    wall = np.stack([xc, side * (naca0012_thickness(xc) + d_wall)], -1)
    # Far field: uniform in the domain, drawn in the domain's frame, kept
    # where outside the profile (a few spares a sample).
    far = np.empty((total, n_far, 2))
    xs = 0.5 * (1.0 - np.cos(np.linspace(0, np.pi, 257)))
    for i in range(total):
        filled = 0
        while filled < n_far:
            cand = rng.uniform(lo, hi, (n_far + 64, 2))
            prof = (cand - quarter) @ rot[i] + quarter          # into the profile's frame
            inside = ((prof[:, 0] >= 0) & (prof[:, 0] <= 1)
                      & (np.abs(prof[:, 1]) <= naca0012_thickness(
                          np.clip(prof[:, 0], 0, 1))))
            take = prof[~inside][:n_far - filled]
            far[i, filled:filled + len(take)] = take
            filled += len(take)
    # Wall distance of the far field: to the nearest of 513 surface points.
    surf = np.concatenate([np.stack([xs, naca0012_thickness(xs)], -1),
                           np.stack([xs[1:], -naca0012_thickness(xs[1:])], -1)])
    d_far = cKDTree(surf).query(far.reshape(-1, 2))[0].reshape(total, n_far)
    pts = np.concatenate([wall, far], 1)                          # profile frame
    x = np.einsum("snk,sjk->snj", pts - quarter, rot) + quarter   # to the domain
    dist = np.concatenate([d_wall, d_far], 1)
    cas = np.broadcast_to(ca[:, None], dist.shape)
    sas = np.broadcast_to(sa[:, None], dist.shape)
    u = 0.97 + 0.17 * np.tanh(3.0 * dist - 0.5) * (1.0 + 4.0 * sas * np.sign(x[..., 1]))
    c = np.stack([dist, cas, sas], -1)
    return {"u": u[:, None, :, None].astype(np.float32),
            "c": c[:, None].astype(np.float32), "x": x[:, None].astype(np.float32)}
