"""Dataset file readers (the port's own copy of ``gaot_tpu/data/readers.py``).

The reference loads NetCDF via xarray (src/datasets/data_processor.py:65-90),
and ``xr.open_dataset(...)[var].values`` applies CF decoding by default:
``_FillValue``/``missing_value`` entries become NaN (with integer storage
promoted to float) and ``scale_factor``/``add_offset`` packing is undone.
xarray/netCDF4 are not available here, so this module reads:

- ``.nc`` NetCDF4 files through h5py (NetCDF4 is HDF5 underneath), with a
  scipy.io fallback for classic NetCDF3 — both apply the same CF decoding
  xarray would, so group arrays match the reference's bit-for-bit,
- ``.npz`` archives with the same group names ('u', 'c', 'x') as a simple
  self-describing interchange format (used by tests and synthetic data).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _attr_scalar(attrs, key):
    """Attribute as a python scalar (h5py/scipy store them as 0-d or len-1
    arrays, scipy netcdf3 as bytes for text attrs)."""
    if key not in attrs:
        return None
    v = attrs[key]
    arr = np.asarray(v)
    if arr.dtype.kind in "SU" or arr.size != 1:
        return None
    return arr.reshape(()).item()


def _cf_decode(data: np.ndarray, attrs) -> np.ndarray:
    """CF-convention decode, matching xarray's default ``decode_cf=True``
    (xarray.coding.variables): mask ``_FillValue``/``missing_value`` to NaN,
    then apply ``scale_factor``/``add_offset``. Integer storage with any of
    these attrs is promoted to float (float64, as xarray does for packed or
    masked ints); pure float data keeps its dtype."""
    fill = _attr_scalar(attrs, "_FillValue")
    missing = _attr_scalar(attrs, "missing_value")
    scale = _attr_scalar(attrs, "scale_factor")
    offset = _attr_scalar(attrs, "add_offset")
    if fill is None and missing is None and scale is None and offset is None:
        return data

    mask = None
    if fill is not None or missing is not None:
        mask = np.zeros(data.shape, bool)
        if fill is not None:
            mask |= data == np.asarray(fill, data.dtype)
        if missing is not None:
            mask |= data == np.asarray(missing, data.dtype)
        if not mask.any():
            mask = None

    if scale is not None or offset is not None:
        data = data.astype(np.float64) * (1.0 if scale is None else scale) \
            + (0.0 if offset is None else offset)
    elif mask is not None and data.dtype.kind != "f":
        data = data.astype(np.float64)

    if mask is not None:
        data = data.copy() if data.base is not None or not data.flags.writeable \
            else data
        data[mask] = np.nan
    return data


def _read_h5(path: str, groups) -> Dict[str, Optional[np.ndarray]]:
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for g in groups:
            if g is not None and g in f:
                ds = f[g]
                out[g] = _cf_decode(np.asarray(ds), dict(ds.attrs))
            else:
                out[g] = None
    return out


def _read_netcdf3(path: str, groups) -> Dict[str, Optional[np.ndarray]]:
    from scipy.io import netcdf_file

    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for g in groups:
            if g is not None and g in f.variables:
                var = f.variables[g]
                out[g] = _cf_decode(np.asarray(var.data),
                                    getattr(var, "_attributes", {}))
            else:
                out[g] = None
    return out


def _read_npz(path: str, groups) -> Dict[str, Optional[np.ndarray]]:
    with np.load(path) as f:
        return {g: (np.asarray(f[g]) if g is not None and g in f else None)
                for g in groups}


def read_dataset(base_path: str, name: str, groups) -> Dict[str, Optional[np.ndarray]]:
    """Load the named dataset's variable groups as NumPy arrays.

    Tries ``<base>/<name>.nc`` then ``<base>/<name>.npz``.
    """
    groups = [g for g in groups]
    nc_path = os.path.join(base_path, f"{name}.nc")
    npz_path = os.path.join(base_path, f"{name}.npz")
    if os.path.exists(nc_path):
        try:
            return _read_h5(nc_path, groups)
        except OSError:
            return _read_netcdf3(nc_path, groups)
    if os.path.exists(npz_path):
        return _read_npz(npz_path, groups)
    raise FileNotFoundError(f"Dataset file not found: {nc_path} (or .npz)")
