"""The port's host data pipeline against the JAX package's, on the same
seed-made inputs: the metadata registry, the coordinate scaler, the readers,
the data processor (splits, statistics, latent queries), the loaders' order
and masks, and the metric. All of it is NumPy in both packages, so every
comparison is for equal bits, apart from the metric's float64 sums (rtol
1e-12)."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import make_static_fx_dataset  # noqa: E402


def test_metadata_registry_matches():
    from gaot_torch.core.metadata import DATASET_METADATA
    from gaot_tpu.core.metadata import DATASET_METADATA as JMETA

    assert list(DATASET_METADATA) == list(JMETA)
    for name, md in DATASET_METADATA.items():
        assert dataclasses.asdict(md) == dataclasses.asdict(JMETA[name]), name


@pytest.mark.parametrize("mode", ["global_scaling", "per_dim_scaling"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coordinate_scaler_matches(mode, dtype):
    from gaot_torch.utils.scaling import CoordinateScaler
    from gaot_tpu.utils.scaling import CoordinateScaler as JScaler

    rng = np.random.default_rng(3)
    fit = rng.uniform([0, -2], [1, 3], (50, 2)).astype(dtype)
    data = rng.uniform(-1, 4, (3, 40, 2)).astype(dtype)
    ours, ref = CoordinateScaler(mode=mode), JScaler(mode=mode)
    got, want = ours(fit), ref(fit)         # fitted on first use
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(ours(data), ref(data))
    np.testing.assert_array_equal(ours.inverse_transform(data),
                                  ref.inverse_transform(data))


def _write_nc4(path, rng):
    """NetCDF4 (HDF5) with a _FillValue in a float variable and int16
    packing (scale_factor, add_offset) in another."""
    import h5py

    u = rng.normal(size=(4, 1, 6, 1)).astype(np.float32)
    u[1, 0, 2, 0] = -999.0
    with h5py.File(path, "w") as f:
        f["u"] = u
        f["u"].attrs["_FillValue"] = np.float32(-999.0)
        f["c"] = rng.integers(-300, 300, (4, 1, 6, 1)).astype(np.int16)
        f["c"].attrs["scale_factor"] = np.float32(0.01)
        f["c"].attrs["add_offset"] = np.float32(1.5)
        f["x"] = rng.uniform(0, 1, (1, 1, 6, 2)).astype(np.float32)


def _write_nc3(path, rng):
    from scipy.io import netcdf_file

    with netcdf_file(path, "w") as f:
        for dim, size in [("s", 4), ("t", 1), ("n", 6), ("v", 1), ("d", 2)]:
            f.createDimension(dim, size)
        vu = f.createVariable("u", np.float32, ("s", "t", "n", "v"))
        u = rng.normal(size=(4, 1, 6, 1)).astype(np.float32)
        u[2, 0, 1, 0] = -1.0
        vu[:] = u
        vu._FillValue = np.float32(-1.0)
        vu.scale_factor = np.float32(2.0)
        vx = f.createVariable("x", np.float32, ("s", "t", "n", "d"))
        vx[:] = rng.uniform(0, 1, (4, 1, 6, 2)).astype(np.float32)


@pytest.mark.parametrize("kind", ["npz", "nc4", "nc3"])
def test_read_dataset_matches(tmp_path, kind):
    from gaot_torch.data.readers import read_dataset
    from gaot_tpu.data.readers import read_dataset as jread

    rng = np.random.default_rng(5)
    if kind == "npz":
        make_static_fx_dataset(str(tmp_path / "toy.npz"), num_samples=5, num_nodes=12)
    elif kind == "nc4":
        pytest.importorskip("h5py")
        _write_nc4(tmp_path / "toy.nc", rng)
    else:
        _write_nc3(tmp_path / "toy.nc", rng)
    groups = ["u", "c", "x", "missing"]
    got, want = read_dataset(str(tmp_path), "toy", groups), jread(str(tmp_path), "toy", groups)
    assert set(got) == set(want)
    for g in groups:
        if want[g] is None:
            assert got[g] is None
            continue
        assert got[g].dtype == want[g].dtype
        np.testing.assert_array_equal(got[g], want[g])     # NaN == NaN here
    if kind != "npz":
        assert np.isnan(got["u"]).sum() == 1


def _dataset_config(tmp_path, **over):
    d = {"name": "toy", "metaname": "elliptic_pdes/Poisson-Gauss",
         "base_path": str(tmp_path), "train_size": 13, "val_size": 4,
         "test_size": 5, "batch_size": 4}
    d.update(over)
    return d


@pytest.mark.parametrize("rand_dataset", [False, True])
def test_data_processor_matches(tmp_path, rand_dataset):
    from gaot_torch.core.config import DatasetConfig, merge_config
    from gaot_torch.core.metadata import DATASET_METADATA
    from gaot_torch.data.data_processor import DataProcessor
    from gaot_tpu.core.config import DatasetConfig as JDatasetConfig
    from gaot_tpu.core.config import merge_config as jmerge
    from gaot_tpu.core.metadata import DATASET_METADATA as JMETA
    from gaot_tpu.data.data_processor import DataProcessor as JDataProcessor

    make_static_fx_dataset(str(tmp_path / "toy.npz"), num_samples=24, num_nodes=40)
    raw = _dataset_config(tmp_path, rand_dataset=rand_dataset)
    meta = "elliptic_pdes/Poisson-Gauss"
    ours = DataProcessor(merge_config(DatasetConfig, raw), DATASET_METADATA[meta], seed=7)
    ref = JDataProcessor(jmerge(JDatasetConfig, raw), JMETA[meta], seed=7)
    got, is_vx = ours.load_and_process_data()
    want, j_vx = ref.load_and_process_data()
    assert is_vx is j_vx is False
    for split in ("train", "val", "test"):
        for k in ("c", "u", "x"):
            assert got[split][k].dtype == want[split][k].dtype
            np.testing.assert_array_equal(got[split][k], want[split][k])
    for k in ("u_mean", "u_std", "c_mean", "c_std"):
        assert getattr(ours, k).dtype == getattr(ref, k).dtype
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    # The latent grid fits the scaler; the nodes are scaled after it.
    lat, jlat = ours.generate_latent_queries((6, 5)), ref.generate_latent_queries((6, 5))
    np.testing.assert_array_equal(lat, jlat)
    np.testing.assert_array_equal(ours.coord_scaler(got["train"]["x"]),
                                  ref.coord_scaler(want["train"]["x"]))
    if rand_dataset:        # the split follows the seed, not the file order
        plain = DataProcessor(merge_config(DatasetConfig, _dataset_config(tmp_path)),
                              DATASET_METADATA[meta], seed=7).load_and_process_data()[0]
        assert not np.array_equal(plain["train"]["u"], got["train"]["u"])


def _as_numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_loader_matches(shuffle):
    from gaot_torch.data.loader import BatchLoader
    from gaot_tpu.data.loader import BatchLoader as JBatchLoader

    take = lambda idx: {"idx": idx.copy()}
    ours = BatchLoader(11, 4, take, shuffle=shuffle, seed=9)
    ref = JBatchLoader(11, 4, take, shuffle=shuffle, seed=9)
    assert len(ours) == len(ref) == 3
    for _ in range(3):                       # the shuffle advances per epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["idx"], w["idx"])
            np.testing.assert_array_equal(g["sample_mask"], w["sample_mask"])
        assert got[-1]["sample_mask"].tolist() == [True, True, True, False]
    assert BatchLoader(3, 8, take).batch_size == 3


@pytest.mark.parametrize("device_data", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
def test_static_fx_loader_matches(shuffle, device_data):
    from gaot_torch.data.loader import PrefetchLoader, make_static_fx_loader
    from gaot_tpu.data.loader import make_static_fx_loader as jmake

    rng = np.random.default_rng(2)
    c = rng.normal(size=(10, 7, 1)).astype(np.float32)
    u = rng.normal(size=(10, 7, 2)).astype(np.float32)
    ours = make_static_fx_loader(c, u, 4, shuffle=shuffle, seed=3,
                                 device_data=device_data, device="cpu")
    ref = jmake(c, u, 4, shuffle=shuffle, seed=3, device_data=False)
    for epoch in range(3):
        # The prefetching iterator yields the same batches in the same order.
        got = list(PrefetchLoader(ours) if epoch == 1 else ours)
        want = list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"c", "u", "sample_mask"}
            assert isinstance(g["u"], torch.Tensor) is device_data
            for k in g:
                np.testing.assert_array_equal(_as_numpy(g[k]), np.asarray(w[k]))


def test_prefetch_loader_raises_worker_errors():
    from gaot_torch.data.loader import BatchLoader, PrefetchLoader

    def bad(idx):
        if idx[0] >= 4:
            raise ValueError("boom")
        return {"idx": idx}

    it = iter(PrefetchLoader(BatchLoader(12, 4, bad)))
    assert next(it)["idx"].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="boom"):
        list(it)


@pytest.mark.parametrize("samples", [6, 7])
@pytest.mark.parametrize("meta", ["elliptic_pdes/Poisson-Gauss",
                                  "compressible_flow/CE-Gauss"])
def test_metrics_match(samples, meta):
    from gaot_torch.core.metadata import DATASET_METADATA
    from gaot_torch.utils.metrics import compute_batch_errors, compute_final_metric
    from gaot_tpu.core.metadata import DATASET_METADATA as JMETA
    from gaot_tpu.utils import metrics as jm

    md = DATASET_METADATA[meta]
    nvar = len(md.active_variables)
    rng = np.random.default_rng(samples)
    gtr = rng.normal(size=(samples, 2, 30, nvar))
    prd = gtr + 0.1 * rng.normal(size=gtr.shape)
    got = compute_batch_errors(gtr, prd, md)
    want = jm.compute_batch_errors(gtr, prd, JMETA[meta])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(compute_final_metric(got),
                               jm.compute_final_metric(want), rtol=1e-12, atol=0)
    # torch.median's lower middle element, not np.median's mean of two.
    assert compute_final_metric(got) == float(
        torch.median(torch.from_numpy(got), dim=0).values.mean())
