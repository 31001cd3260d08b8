"""Static (time-independent) data processing (the port's copy of
``gaot_tpu/data/data_processor.py``, the same NumPy calls in the same
dtypes, so splits and statistics are bit-identical).

Host-side NumPy equivalent of the reference DataProcessor
(src/datasets/data_processor.py:20-378): load raw arrays, determine the
coordinate mode (fx/vx), split train/val/test, z-score normalize on train
statistics, and generate the regular latent query grid. Batching for the
device lives in data/loader.py; graph construction in data/graph_builder.py.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.config import DatasetConfig
from ..core.metadata import Metadata
from ..utils.scaling import CoordinateScaler
from .readers import read_dataset

EPSILON = 1e-10

POSEIDON_DATASETS = [
    "Poisson-Gauss", "CE-Gauss", "CE-RP", "CE-CRP", "CE-KH", "CE-RPUI",
    "NS-Gauss", "NS-PwC", "NS-SL", "NS-SVS", "NS-Sines",
]


class DataProcessor:
    """Loads, splits, and normalizes a static dataset."""

    def __init__(self, dataset_config: DatasetConfig, metadata: Metadata,
                 dtype=np.float32, seed: int = 0):
        self.dataset_config = dataset_config
        self.metadata = metadata
        self.dtype = dtype
        self.u_mean: Optional[np.ndarray] = None
        self.u_std: Optional[np.ndarray] = None
        self.c_mean: Optional[np.ndarray] = None
        self.c_std: Optional[np.ndarray] = None
        self.coord_scaler: Optional[CoordinateScaler] = None
        # Split permutations derive from the experiment seed (the reference
        # draws them from the globally seeded numpy state,
        # src/core/base_trainer.py:60 + data_processor.py:206-207). Unlike
        # the reference's seed+rank offset, the SAME seed is used on every
        # host so multi-host splits agree.
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def load_and_process_data(self) -> Tuple[Dict, bool]:
        raw = self._load_raw_data()
        is_vx = self._determine_coordinate_mode()
        splits = self._split_and_normalize(raw, is_vx)
        return splits, is_vx

    def _load_raw_data(self) -> Dict:
        md = self.metadata
        raw = read_dataset(self.dataset_config.base_path, self.dataset_config.name,
                           [md.group_u, md.group_c, md.group_x])
        u = raw[md.group_u]
        c = raw[md.group_c] if md.group_c is not None else None
        x = raw[md.group_x] if md.group_x is not None else None
        if x is None:
            x = self._generate_grid_coords(u)
        return {"u": u, "c": c, "x": x}

    def _generate_grid_coords(self, u: np.ndarray) -> np.ndarray:
        """Structured-grid coordinate synthesis from the metadata domain
        (reference data_processor.py:106-123)."""
        if self.metadata.domain_x is None:
            raise ValueError("Either group_x or domain_x must be specified")
        (x_min, y_min), (x_max, y_max) = self.metadata.domain_x
        nx, ny = u.shape[-2], u.shape[-1]
        xv, yv = np.meshgrid(np.linspace(x_min, x_max, nx),
                             np.linspace(y_min, y_max, ny), indexing="ij")
        coords = np.stack([xv, yv], axis=-1).reshape(-1, 2)
        return np.broadcast_to(coords[None, None], (u.shape[0], 1) + coords.shape).copy()

    def _determine_coordinate_mode(self) -> bool:
        """True if coordinates vary per sample (vx)."""
        if self.metadata.group_x is not None:
            return not self.metadata.fix_x
        return False

    def _get_split_indices(self, total: int):
        cfg = self.dataset_config
        if cfg.train_size + cfg.val_size + cfg.test_size > total:
            raise ValueError(
                f"train+val+test ({cfg.train_size}+{cfg.val_size}+{cfg.test_size}) "
                f"exceeds dataset size {total}")
        if cfg.rand_dataset:
            indices = self.rng.permutation(total)
        else:
            indices = np.arange(total)
        return (indices[:cfg.train_size],
                indices[cfg.train_size:cfg.train_size + cfg.val_size],
                indices[total - cfg.test_size:] if cfg.test_size else indices[:0])

    def _split_and_normalize(self, raw: Dict, is_vx: bool) -> Dict:
        u, c, x = raw["u"], raw["c"], raw["x"]

        if (self.dataset_config.name in POSEIDON_DATASETS
                and self.dataset_config.use_sparse):
            u = u[..., :9216, :]
            c = c[..., :9216, :] if c is not None else None
            x = x[..., :9216, :] if x is not None else None

        u = u[..., list(self.metadata.active_variables)]
        if u.shape[1] != 1:
            raise ValueError("Static datasets must have a single timestep")

        tr, va, te = self._get_split_indices(len(u))
        u_tr, u_va, u_te = u[tr].copy(), u[va].copy(), u[te].copy()
        if c is not None:
            c_tr, c_va, c_te = c[tr].copy(), c[va].copy(), c[te].copy()
        else:
            c_tr = c_va = c_te = None

        if is_vx:
            x_tr, x_va, x_te = x[tr], x[va], x[te]
        else:
            x_coord = x[0, 0] if x.ndim == 4 else x
            x_tr = x_va = x_te = np.asarray(x_coord)

        # Train-statistics z-score normalization (reference lines 217-248).
        self.u_mean = u_tr.reshape(-1, u_tr.shape[-1]).mean(0)
        self.u_std = u_tr.reshape(-1, u_tr.shape[-1]).std(0) + EPSILON
        u_tr = (u_tr - self.u_mean) / self.u_std
        u_va = (u_va - self.u_mean) / self.u_std
        u_te = (u_te - self.u_mean) / self.u_std
        if c_tr is not None:
            self.c_mean = c_tr.reshape(-1, c_tr.shape[-1]).mean(0)
            self.c_std = c_tr.reshape(-1, c_tr.shape[-1]).std(0) + EPSILON
            c_tr = (c_tr - self.c_mean) / self.c_std
            c_va = (c_va - self.c_mean) / self.c_std
            c_te = (c_te - self.c_mean) / self.c_std

        def conv_u(a):
            return np.ascontiguousarray(np.squeeze(a, axis=1), dtype=self.dtype)

        def conv_x(a):
            if is_vx:
                a = np.squeeze(a, axis=1) if a.ndim == 4 else a
            return np.ascontiguousarray(a, dtype=self.dtype)

        return {
            "train": {"c": conv_u(c_tr) if c_tr is not None else None,
                      "u": conv_u(u_tr), "x": conv_x(x_tr)},
            "val": {"c": conv_u(c_va) if c_va is not None else None,
                    "u": conv_u(u_va), "x": conv_x(x_va)},
            "test": {"c": conv_u(c_te) if c_te is not None else None,
                     "u": conv_u(u_te), "x": conv_x(x_te)},
        }

    # ------------------------------------------------------------------
    def generate_latent_queries(self, token_size) -> np.ndarray:
        """Regular latent grid over the physical domain, coordinate-scaled
        (reference data_processor.py:280-321)."""
        domain = self.metadata.domain_x
        axes = [np.linspace(domain[0][i], domain[1][i], token_size[i])
                for i in range(len(token_size))]
        mesh = np.meshgrid(*axes, indexing="ij")
        queries = np.stack(mesh, axis=-1).reshape(-1, len(token_size))
        if self.coord_scaler is None:
            self.coord_scaler = CoordinateScaler(
                target_range=(-1, 1), mode=self.dataset_config.coord_scaling)
        return self.coord_scaler(queries).astype(self.dtype)
