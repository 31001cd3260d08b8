"""Synthetic data at the layouts of public sets, for the port's tests and
``chip_smoke.py``.

- :func:`make_elasticity_dataset`: the Elasticity set (Geo-FNO), a mesh
  per sample: 972 points a sample on a unit cell with a void; here each
  sample's points are uniform in [0, 1]^2 outside a circular void of its
  own radius, ``c`` (one channel) is the point's distance to the void and
  ``u`` (one channel, the stress) a smooth function of it and of the
  position. Written as u, c [S, 1, N, 1] and x [S, 1, N, 2].
- :func:`make_poseidon_sequential_dataset`: the Poseidon time-dependent
  sets (NS-Gauss, CE-CRP, ...): 21 snapshots of a 128 x 128 lattice on
  [0, 1]^2, one shared point cloud. Written as u [S, 21, N, V] and
  x [1, 1, N, 2]; no ``c``.
"""
import numpy as np

ELASTICITY_POINTS = 972
POSEIDON_GRID = 128
POSEIDON_STEPS = 21


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


def make_poseidon_sequential_dataset(path: str, num_samples: int, channels: int,
                                     grid: int = POSEIDON_GRID,
                                     steps: int = POSEIDON_STEPS, seed: int = 0):
    """Smooth travelling waves on the ``grid`` x ``grid`` lattice: channel v
    of sample s is ``a·cos(2π(k·x - ω·t) + φ)`` with its own amplitude,
    wave vector, frequency and phase, over ``steps`` times in [0, 1]."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(0, 1, grid)
    x = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
    t = np.linspace(0, 1, steps)
    amp = rng.uniform(0.5, 1.5, (num_samples, channels))
    k = rng.integers(1, 4, (num_samples, channels, 2))
    omega = rng.uniform(0.5, 2.0, (num_samples, channels))
    phase = rng.uniform(0, 2 * np.pi, (num_samples, channels))
    u = np.empty((num_samples, steps, grid * grid, channels), np.float32)
    for s in range(num_samples):          # one sample at a time: bounded memory
        kx = x @ k[s].T                                       # [N, V]
        arg = kx[None] - omega[s] * t[:, None, None] + phase[s] / (2 * np.pi)
        u[s] = amp[s] * np.cos(2 * np.pi * arg)
    np.savez(path, u=u, x=x[None, None].astype(np.float32))
    return path
