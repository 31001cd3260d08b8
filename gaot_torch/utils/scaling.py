"""Coordinate scaling utilities (host-side, NumPy; the port's own copy of
``gaot_tpu/utils/scaling.py``).

Provides the same scaling strategies as the reference
(src/utils/scaling.py:10-238): min-max rescale to a target range, a
CoordinateScaler with 'global_scaling' / 'per_dim_scaling' modes, and generic
min-max / standard scalers. All operate on NumPy arrays — coordinate scaling
happens in the host data pipeline before device transfer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def rescale(data: np.ndarray, target_range: Tuple[float, float] = (-1, 1)) -> np.ndarray:
    """Min-max rescale per trailing dimension to ``target_range``."""
    data = np.asarray(data)
    data_min = data.min(axis=0, keepdims=True)
    data_max = data.max(axis=0, keepdims=True)
    data_range = data_max - data_min
    data_range = np.where(data_range == 0, 1.0, data_range)
    normalized = (data - data_min) / data_range
    lo, hi = target_range
    return normalized * (hi - lo) + lo


class CoordinateScaler:
    """Fit-once coordinate scaler with global or per-dimension min/max modes."""

    def __init__(self, target_range: Tuple[float, float] = (-1, 1),
                 mode: str = "per_dim_scaling"):
        if mode not in ("global_scaling", "per_dim_scaling"):
            raise ValueError(f"Unsupported scaling mode: {mode}")
        self.target_range = target_range
        self.mode = mode
        self._min = None
        self._range = None

    def fit(self, coords: np.ndarray) -> "CoordinateScaler":
        coords = np.asarray(coords, dtype=np.float64)
        flat = coords.reshape(-1, coords.shape[-1])
        if self.mode == "global_scaling":
            gmin, gmax = flat.min(), flat.max()
            self._min = np.full(flat.shape[-1], gmin)
            rng = gmax - gmin
            self._range = np.full(flat.shape[-1], rng if rng != 0 else 1.0)
        else:
            cmin = flat.min(axis=0)
            cmax = flat.max(axis=0)
            rng = cmax - cmin
            self._min = cmin
            self._range = np.where(rng == 0, 1.0, rng)
        return self

    def transform(self, coords: np.ndarray) -> np.ndarray:
        coords = np.asarray(coords)
        if self._min is None:
            self.fit(coords)
        shape = coords.shape
        flat = coords.reshape(-1, shape[-1]).astype(np.float64)
        normalized = (flat - self._min) / self._range
        lo, hi = self.target_range
        scaled = normalized * (hi - lo) + lo
        return scaled.reshape(shape).astype(coords.dtype if coords.dtype.kind == "f" else np.float32)

    def inverse_transform(self, coords: np.ndarray) -> np.ndarray:
        if self._min is None:
            raise ValueError("Scaler must be fitted before inverse transform")
        coords = np.asarray(coords)
        shape = coords.shape
        flat = coords.reshape(-1, shape[-1]).astype(np.float64)
        lo, hi = self.target_range
        normalized = (flat - lo) / (hi - lo)
        original = normalized * self._range + self._min
        return original.reshape(shape).astype(coords.dtype if coords.dtype.kind == "f" else np.float32)

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        return self.transform(coords)


class MinMaxScaler:
    """Min-max scaler over the leading axis."""

    def __init__(self, feature_range: Tuple[float, float] = (0, 1)):
        self.feature_range = feature_range
        self.data_min = None
        self.scale = None

    def fit(self, data: np.ndarray) -> "MinMaxScaler":
        data = np.asarray(data)
        self.data_min = data.min(axis=0, keepdims=True)
        data_range = data.max(axis=0, keepdims=True) - self.data_min
        data_range = np.where(data_range == 0, 1.0, data_range)
        lo, hi = self.feature_range
        self.scale = (hi - lo) / data_range
        return self

    def transform(self, data: np.ndarray) -> np.ndarray:
        if self.scale is None:
            raise ValueError("Scaler must be fitted before transform")
        lo, _ = self.feature_range
        return (np.asarray(data) - self.data_min) * self.scale + lo

    def fit_transform(self, data: np.ndarray) -> np.ndarray:
        return self.fit(data).transform(data)

    def inverse_transform(self, data: np.ndarray) -> np.ndarray:
        if self.scale is None:
            raise ValueError("Scaler must be fitted before inverse transform")
        lo, _ = self.feature_range
        return (np.asarray(data) - lo) / self.scale + self.data_min


class StandardScaler:
    """Z-score scaler over the leading axis."""

    def __init__(self, epsilon: float = 1e-8):
        self.epsilon = epsilon
        self.mean = None
        self.std = None

    def fit(self, data: np.ndarray) -> "StandardScaler":
        data = np.asarray(data)
        self.mean = data.mean(axis=0, keepdims=True)
        self.std = data.std(axis=0, ddof=1, keepdims=True) + self.epsilon
        return self

    def transform(self, data: np.ndarray) -> np.ndarray:
        if self.mean is None:
            raise ValueError("Scaler must be fitted before transform")
        return (np.asarray(data) - self.mean) / self.std

    def fit_transform(self, data: np.ndarray) -> np.ndarray:
        return self.fit(data).transform(data)

    def inverse_transform(self, data: np.ndarray) -> np.ndarray:
        if self.mean is None:
            raise ValueError("Scaler must be fitted before inverse transform")
        return np.asarray(data) * self.std + self.mean
