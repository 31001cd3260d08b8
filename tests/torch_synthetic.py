"""Synthetic data at the layout of the Elasticity set, for the port's vx
tests and ``chip_smoke.py``: a mesh per sample.

The public Elasticity set (Geo-FNO) holds 972 points a sample on a unit
cell with a void; here each sample's points are uniform in [0, 1]^2
outside a circular void of its own radius, ``c`` (one channel) is the
point's distance to the void and ``u`` (one channel, the stress) a smooth
function of it and of the position. Written as the readers expect:
u, c [S, 1, N, 1] and x [S, 1, N, 2]."""
import numpy as np

ELASTICITY_POINTS = 972


def make_elasticity_dataset(path: str, num_samples: int = 24,
                            num_nodes: int = ELASTICITY_POINTS, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = np.empty((num_samples, num_nodes, 2), np.float32)
    radius = rng.uniform(0.15, 0.35, num_samples)
    for i in range(num_samples):
        pts = np.empty((0, 2))
        while len(pts) < num_nodes:
            cand = rng.uniform(0, 1, (2 * num_nodes, 2))
            keep = np.linalg.norm(cand - 0.5, axis=1) > radius[i]
            pts = np.concatenate([pts, cand[keep]])
        x[i] = pts[:num_nodes]
    dist = np.linalg.norm(x - 0.5, axis=-1) - radius[:, None]      # [S, N]
    c = dist[..., None]
    u = (187.477 + 127.046 * (np.exp(-8.0 * dist) * (1.0 + 0.5 * np.cos(
        2 * np.pi * x[..., 0])) - 0.4))[..., None]
    np.savez(path, u=u[:, None].astype(np.float32), c=c[:, None].astype(np.float32),
             x=x[:, None])
    return path
