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
- :func:`make_naca_dataset`: the airfoil sets (naca0012 and its kin), a
  mesh per sample clustered around a NACA 0012 profile (the public 4-digit
  thickness formula) in the metadata domain [-1, 2.5] x [-1.5, 2]: part of
  the nodes in a boundary layer over the profile, denser towards the
  leading and trailing edges, the rest uniform outside the profile; each
  sample's mesh its own draw, rotated by its own angle of attack. ``c``
  (three channels) holds the node's wall distance and the cosine and sine
  of the angle, ``u`` (one channel) a smooth field of them. Written as
  u [S, 1, N, 1], c [S, 1, N, 3] and x [S, 1, N, 2].
"""
import numpy as np
from scipy.spatial import cKDTree

ELASTICITY_POINTS = 972
NACA_POINTS = 6144
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


def naca0012_thickness(x: np.ndarray) -> np.ndarray:
    """The half thickness of the NACA 0012 profile at chord positions x in
    [0, 1] (chord 1): 5·0.12·(0.2969√x − 0.1260x − 0.3516x² + 0.2843x³
    − 0.1015x⁴)."""
    return 5 * 0.12 * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x ** 2
                       + 0.2843 * x ** 3 - 0.1015 * x ** 4)


def make_naca_dataset(path: str, num_samples: int = 12, num_nodes: int = NACA_POINTS,
                      wall_share: float = 0.4, layer: float = 0.02, seed: int = 0):
    """``wall_share`` of each sample's nodes lie in the boundary layer: at a
    cosine-spaced chord position on either side, at an exponential distance
    of mean ``layer`` (in chords) above the surface; the rest are uniform
    in the domain outside the profile. Each sample's profile is turned
    about its quarter chord by its own angle of attack, uniform in
    [-5, 5] degrees."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([-1.0, -1.5]), np.array([2.5, 2.0])
    n_wall = int(round(wall_share * num_nodes))
    alpha = np.deg2rad(rng.uniform(-5.0, 5.0, num_samples))
    xs = 0.5 * (1.0 - np.cos(np.linspace(0, np.pi, 129)))
    surf = np.concatenate([np.stack([xs, naca0012_thickness(xs)], -1),
                           np.stack([xs[1:], -naca0012_thickness(xs[1:])], -1)])
    surf_tree = cKDTree(surf)
    x = np.empty((num_samples, num_nodes, 2), np.float32)
    dist = np.empty((num_samples, num_nodes), np.float32)
    for i in range(num_samples):
        c, s_ = np.cos(alpha[i]), np.sin(alpha[i])
        rot = np.array([[c, -s_], [s_, c]])
        to_domain = lambda p: (p - [0.25, 0.0]) @ rot.T + [0.25, 0.0]
        to_profile = lambda p: (p - [0.25, 0.0]) @ rot + [0.25, 0.0]
        xc = 0.5 * (1.0 - np.cos(np.pi * rng.uniform(0, 1, n_wall)))
        side = rng.choice([-1.0, 1.0], n_wall)
        d_wall = rng.exponential(layer, n_wall)
        wall = np.stack([xc, side * (naca0012_thickness(xc) + d_wall)], -1)
        far = np.empty((0, 2))
        while len(far) < num_nodes - n_wall:
            cand = to_profile(rng.uniform(lo, hi, (2 * num_nodes, 2)))
            inside = ((cand[:, 0] >= 0) & (cand[:, 0] <= 1)
                      & (np.abs(cand[:, 1]) <= naca0012_thickness(
                          np.clip(cand[:, 0], 0, 1))))
            far = np.concatenate([far, cand[~inside]])
        far = far[:num_nodes - n_wall]
        # The far field's wall distance: to the nearest of 257 surface points.
        d_far = surf_tree.query(far)[0]
        x[i] = to_domain(np.concatenate([wall, far]))
        dist[i] = np.concatenate([d_wall, d_far])
    ca = np.cos(alpha)[:, None] * np.ones_like(dist)
    sa = np.sin(alpha)[:, None] * np.ones_like(dist)
    u = 0.97 + 0.17 * np.tanh(3.0 * dist - 0.5) * (1.0 + 4.0 * sa * np.sign(x[..., 1]))
    np.savez(path, u=u[:, None, :, None].astype(np.float32),
             c=np.stack([dist, ca, sa], -1)[:, None].astype(np.float32), x=x[:, None])
    return path
