"""Sequential (time-dependent) data processing.

Counterpart of ``gaot_tpu/data/sequential.py``, with the same NumPy calls in
the same dtypes, so the host route is bit-identical:

- :func:`compute_sequential_stats` (u and c statistics, the start-time and
  time-difference statistics over the lag grid, the residual and
  derivative statistics of consecutive steps) and
  :func:`generate_time_pairs`;
- :class:`SequentialDataProcessor`: the trajectories truncated to
  ``max_time_diff + 1`` steps, the Poseidon ``use_sparse`` cut to 9216
  nodes, grid coordinates where the file has none;
- :class:`DynamicPairBatcher`: every (sample, time pair) is one training
  item; ``get_batch`` builds ``[u_norm ‖ c_norm ‖ start_time ‖ time_diff]``
  and the stepper mode's target on the host (NumPy float64, cast to fp32),
  and :meth:`DynamicPairBatcher.device_get_batch` builds them on the device
  from u and c placed there once (fp32 arithmetic, as the JAX package's
  ``device_parts``);
- :class:`RolloutTestBatcher`: the initial state of each test trajectory
  and its ground-truth sequence.

On vx data (a mesh per sample), u and c are put in the graphs' Morton node
order and padded to N_pad, and each batch carries the graph buffers, the
coordinates and the node mask of its samples: a batch that holds a sample
twice, under two time pairs, holds its graphs twice, one copy in each slot,
with the batch's ``vx_layout`` beside them. Under spatial parallelism the
graph buffers are a rank's cut (its rows, all their sources); u, c, the
coordinates and the node mask stay whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .data_processor import EPSILON, POSEIDON_DATASETS, DataProcessor
from .graph_builder import apply_node_perm, vx_graph_buffers, vx_layout
from .loader import DEVICE_DATA_BYTE_LIMIT, BatchLoader, host_reason, to_device
from .readers import read_dataset

STEPPER_MODES = ("output", "residual", "time_der")


def compute_sequential_stats(u_data: np.ndarray, c_data: Optional[np.ndarray],
                             t_values: np.ndarray, metadata=None,
                             max_time_diff: int = 14, time_step: int = 2,
                             sample_rate: float = 1.0,
                             use_metadata_stats: bool = False,
                             use_time_norm: bool = True) -> Dict:
    """Statistics for sequential training (reference
    trainer_utils.py:203-308)."""
    stats: Dict = {}

    if use_metadata_stats and metadata is not None \
            and hasattr(metadata, "u_mean") and hasattr(metadata, "u_std"):
        stats["u"] = {"mean": np.asarray(metadata.u_mean),
                      "std": np.asarray(metadata.u_std)}
    else:
        flat = u_data.reshape(-1, u_data.shape[-1])
        stats["u"] = {"mean": flat.mean(0), "std": flat.std(0) + EPSILON}

    if c_data is not None:
        flat = c_data.reshape(-1, c_data.shape[-1])
        stats["c"] = {"mean": flat.mean(0), "std": flat.std(0) + EPSILON}

    if use_time_norm:
        # The lag grid over the steps present (a trajectory may be shorter
        # than max_time_diff + 1).
        t_in, t_out = generate_time_pairs(min(max_time_diff, len(t_values) - 1),
                                          time_step)
        start_times = t_values[t_in]
        time_diffs = t_values[t_out] - t_values[t_in]
        stats["start_time"] = {"mean": start_times.mean(),
                               "std": start_times.std() + EPSILON}
        stats["time_diffs"] = {"mean": time_diffs.mean(),
                               "std": time_diffs.std() + EPSILON}

    # At least one sample, so that the residual and derivative statistics
    # the stepper modes need exist for a tiny split.
    n_sub = min(max(1, int(len(u_data) * sample_rate)), len(u_data))
    if n_sub > 0:
        t_lim = min(max_time_diff, u_data.shape[1] - 1)
        u_sub = u_data[:n_sub, :t_lim + 1]                       # [S, T, N, V]
        residuals = u_sub[:, 1:] - u_sub[:, :-1]                 # [S, T-1, N, V]
        dts = (t_values[1:t_lim + 1] - t_values[:t_lim]).reshape(1, -1, 1, 1)
        derivatives = residuals / dts
        res_flat = residuals.reshape(-1, residuals.shape[-1])
        der_flat = derivatives.reshape(-1, derivatives.shape[-1])
        stats["res"] = {"mean": res_flat.mean(0), "std": res_flat.std(0) + EPSILON}
        stats["der"] = {"mean": der_flat.mean(0), "std": der_flat.std(0) + EPSILON}
    return stats


def generate_time_pairs(num_timesteps: int, time_step: int) -> Tuple[np.ndarray, np.ndarray]:
    """All (i, i + lag) pairs with lag in {time_step, 2·time_step, ...} on
    the stride grid (reference data_utils.py:121-135)."""
    t_in, t_out = [], []
    for lag in range(time_step, num_timesteps + 1, time_step):
        for i in range(0, num_timesteps - lag + 1, time_step):
            t_in.append(i)
            t_out.append(i + lag)
    return np.asarray(t_in), np.asarray(t_out)


class SequentialDataProcessor(DataProcessor):
    """Loads a sequential dataset with its time axis, splits it and
    computes the sequential statistics of the training split."""

    def __init__(self, dataset_config, metadata, dtype=np.float32, seed: int = 0):
        super().__init__(dataset_config, metadata, dtype, seed=seed)
        self.t_values: Optional[np.ndarray] = None
        self.stats: Optional[Dict] = None
        self.max_time_diff = dataset_config.max_time_diff
        self.time_step = dataset_config.time_step
        self.stepper_mode = dataset_config.stepper_mode
        self.use_time_norm = dataset_config.use_time_norm
        self.use_metadata_stats = dataset_config.use_metadata_stats
        self.sample_rate = dataset_config.sample_rate

    def load_and_process_data(self) -> Tuple[Dict, bool]:
        raw = self._load_raw_sequential_data()
        is_vx = self._determine_coordinate_mode()
        return self._split_sequential(raw, is_vx), is_vx

    def _load_raw_sequential_data(self) -> Dict:
        md = self.metadata
        raw = read_dataset(self.dataset_config.base_path, self.dataset_config.name,
                           [md.group_u, md.group_c, md.group_x])
        u = raw[md.group_u]
        c = raw[md.group_c] if md.group_c is not None else None
        x = raw[md.group_x] if md.group_x is not None else None
        if x is None:
            x = self._generate_sequential_grid_coords(u)
        if md.domain_t is None:
            raise ValueError("metadata.domain_t is None for a sequential dataset")
        t0, t1 = md.domain_t
        self.t_values = np.linspace(t0, t1, u.shape[1])

        if (self.dataset_config.name in POSEIDON_DATASETS
                and self.dataset_config.use_sparse):
            u = u[:, :, :9216, :]
            c = c[:, :, :9216, :] if c is not None else None
            x = x[:, :, :9216, :]

        u = u[..., list(md.active_variables)]
        return {"u": u, "c": c, "x": x}

    def _generate_sequential_grid_coords(self, u: np.ndarray) -> np.ndarray:
        num_nodes = u.shape[2]
        grid = int(np.sqrt(num_nodes))
        if grid * grid != num_nodes:
            raise ValueError(f"Cannot create square grid from {num_nodes} nodes")
        (x_min, y_min), (x_max, y_max) = self.metadata.domain_x
        xv, yv = np.meshgrid(np.linspace(x_min, x_max, grid),
                             np.linspace(y_min, y_max, grid), indexing="ij")
        return np.stack([xv, yv], -1).reshape(-1, 2)[None, None]

    def _split_sequential(self, raw: Dict, is_vx: bool) -> Dict:
        u, c, x = raw["u"], raw["c"], raw["x"]
        # T truncated to max_time_diff + 1 (reference sequential processor,
        # lines 156-164).
        if self.max_time_diff is not None:
            t_max = self.max_time_diff + 1
            u = u[:, :t_max]
            c = c[:, :t_max] if c is not None else None
            if is_vx and x.shape[1] > 1:
                x = x[:, :t_max]
            self.t_values = self.t_values[:t_max]

        tr, va, te = self._get_split_indices(u.shape[0])
        out = {}
        for name, idx in (("train", tr), ("val", va), ("test", te)):
            out[name] = {
                "u": np.ascontiguousarray(u[idx], dtype=self.dtype),
                "c": (np.ascontiguousarray(c[idx], dtype=self.dtype)
                      if c is not None else None),
                "x": (np.ascontiguousarray(x[idx], dtype=self.dtype) if is_vx
                      else np.asarray(x[0, 0], dtype=self.dtype)),
                "t": self.t_values.astype(self.dtype),
            }

        self.stats = compute_sequential_stats(
            out["train"]["u"], out["train"]["c"], self.t_values,
            metadata=self.metadata, max_time_diff=self.max_time_diff,
            time_step=self.time_step, sample_rate=self.sample_rate,
            use_metadata_stats=self.use_metadata_stats,
            use_time_norm=self.use_time_norm)
        return out


def _vx_node_layout(graphs, u: np.ndarray, c: Optional[np.ndarray]):
    """u and c [S, T, N, ·] in the graphs' Morton node order, padded with
    zero nodes to the graphs' N_pad."""
    n_pad = graphs.coords.shape[1]

    def layout(a):
        if a is None:
            return None
        a = apply_node_perm(graphs.node_perm, a)
        pad = n_pad - a.shape[2]
        return np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0))) if pad > 0 else a

    return layout(u), layout(c)


def _sample_buffers(graphs) -> Dict[str, np.ndarray]:
    """A vx split's per-sample batch buffers: the coordinates, the node mask
    and every graph buffer (``node_perm`` is a record of the build, not a
    batch input)."""
    bufs = vx_graph_buffers(graphs)
    bufs.pop("node_perm", None)
    return bufs


class DynamicPairBatcher:
    """Time-pair training items (the reference's DynamicPairDataset): item
    ``i`` is sample ``i // num_pairs`` under pair ``i % num_pairs``.

    ``graphs`` (a VxSplitGraphs) switches on vx mode: u and c go to the
    graphs' node layout and each batch carries its samples' graph buffers,
    coordinates and node mask.
    """

    def __init__(self, u_data: np.ndarray, c_data: Optional[np.ndarray],
                 t_values: np.ndarray, max_time_diff: int, time_step: int,
                 stepper_mode: str, stats: Dict, use_time_norm: bool = True,
                 graphs=None):
        if stepper_mode not in STEPPER_MODES:
            raise ValueError(f"Unsupported stepper_mode: {stepper_mode}")
        if graphs is not None:
            u_data, c_data = _vx_node_layout(graphs, u_data, c_data)
        self.u = u_data
        self.c = c_data
        self.stats = stats
        self.stepper_mode = stepper_mode

        num_timesteps = min(u_data.shape[1] - 1, max_time_diff)
        self.t_values = t_values[:num_timesteps + 1]
        self.t_in, self.t_out = generate_time_pairs(num_timesteps, time_step)
        self.time_diffs = self.t_values[self.t_out] - self.t_values[self.t_in]
        if use_time_norm and stats is not None:
            st = stats["start_time"]
            td = stats["time_diffs"]
            self.start_norm = (self.t_values[self.t_in] - st["mean"]) / st["std"]
            self.diff_norm = (self.time_diffs - td["mean"]) / td["std"]
        else:
            self.start_norm = self.t_values[self.t_in]
            self.diff_norm = self.time_diffs

        self.num_samples = u_data.shape[0]
        self.num_pairs = len(self.t_in)
        self.buffers = _sample_buffers(graphs) if graphs is not None else {}
        self.num_latent = graphs.num_latent if graphs is not None else None

    def __len__(self) -> int:
        return self.num_samples * self.num_pairs

    def get_batch(self, flat_idx: np.ndarray) -> Dict[str, np.ndarray]:
        """The host route: NumPy arrays, normalised in float64 and cast to
        the data's dtype."""
        s_idx = flat_idx // self.num_pairs
        p_idx = flat_idx % self.num_pairs
        t_in = self.t_in[p_idx]
        t_out = self.t_out[p_idx]

        u_in = self.u[s_idx, t_in]                                # [B, N, V]
        u_out = self.u[s_idx, t_out]
        u_stats = self.stats["u"]
        u_in_norm = (u_in - u_stats["mean"]) / u_stats["std"]

        feats = [u_in_norm]
        if self.c is not None:
            c_in = self.c[s_idx, t_in]
            if "c" in self.stats:
                c_in = (c_in - self.stats["c"]["mean"]) / self.stats["c"]["std"]
            feats.append(c_in)
        n = u_in.shape[1]
        ones = np.ones((len(flat_idx), n, 1), dtype=u_in.dtype)
        feats.append(ones * self.start_norm[p_idx][:, None, None])
        feats.append(ones * self.diff_norm[p_idx][:, None, None])
        inputs = np.concatenate(feats, axis=-1)

        if self.stepper_mode == "output":
            target = (u_out - u_stats["mean"]) / u_stats["std"]
        elif self.stepper_mode == "residual":
            r = self.stats["res"]
            target = (u_out - u_in - r["mean"]) / r["std"]
        else:                                               # time_der
            d = self.stats["der"]
            dt = self.time_diffs[p_idx][:, None, None]
            target = ((u_out - u_in) / dt - d["mean"]) / d["std"]

        batch = {"input": inputs.astype(self.u.dtype),
                 "target": target.astype(self.u.dtype)}
        for k, v in self.buffers.items():
            batch[k] = v[s_idx]
        return batch

    def buffer_bytes(self) -> int:
        """The bytes the device route places: u, c and the graph buffers."""
        return (self.u.nbytes + (self.c.nbytes if self.c is not None else 0)
                + sum(v.nbytes for v in self.buffers.values()))

    def device_parts(self, device):
        """(buffers, assemble) of the device route, the port's counterpart
        of the JAX package's ``device_parts``: u, c and the vx buffers go
        to ``device`` once, as do the pair tables (each pair's input and
        output step) and the pairs' time features, and
        ``assemble(buffers, flat_idx)`` builds a batch from a [B] index
        tensor on the device with device ops alone (the epoch path gathers
        its steps' batches with it inside a CUDA graph). It selects the
        rows of u as [S·T, N, V] with one ``index_select`` for the input
        and the output steps together, one for c and one per vx buffer
        (:attr:`row_selects`), reads the pair tables with ``take``, and
        normalises in fp32."""
        s, t = self.u.shape[:2]
        bufs = {"u": torch.from_numpy(self.u.reshape(s * t, *self.u.shape[2:])).to(device)}
        if self.c is not None:
            bufs["c"] = torch.from_numpy(self.c.reshape(s * t, *self.c.shape[2:])).to(device)
        bufs.update({k: torch.from_numpy(v).to(device) for k, v in self.buffers.items()})
        dtype = bufs["u"].dtype

        def table(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

        def stat(key, field):
            return table(np.asarray(self.stats[key][field]), np.float32)

        u_mean, u_std = stat("u", "mean"), stat("u", "std")
        c_stats = (stat("c", "mean"), stat("c", "std")) if "c" in self.stats else None
        step = {"residual": "res", "time_der": "der"}.get(self.stepper_mode)
        step_stats = (stat(step, "mean"), stat(step, "std")) if step else None
        num_pairs, stepper = self.num_pairs, self.stepper_mode
        # [2, P] the pairs' input and output steps, [3, P] their normalised
        # start time and time difference and the raw time difference; a
        # batch reads column p of row r at r·P + p.
        steps = table(np.stack([self.t_in, self.t_out]), np.int64)
        feats = table(np.stack([self.start_norm, self.diff_norm, self.time_diffs]),
                      np.float32)
        rows3 = table(np.arange(3)[:, None] * num_pairs, np.int64)
        extra = [k for k in bufs if k not in ("u", "c")]

        def assemble(bufs, flat_idx):
            b = flat_idx.shape[0]
            s_idx = torch.div(flat_idx, num_pairs, rounding_mode="floor")
            p_idx = flat_idx - s_idx * num_pairs
            pair = p_idx + rows3[:2]                                    # [2, B]
            rows = (s_idx * t + torch.take(steps, pair)).reshape(-1)    # in, then out
            f = torch.take(feats, p_idx + rows3)                        # [3, B]
            sel = bufs["u"].index_select(0, rows)
            u_in, u_out = sel[:b], sel[b:]
            parts = [(u_in - u_mean) / u_std]
            if "c" in bufs:
                c_in = bufs["c"].index_select(0, rows[:b])
                if c_stats is not None:
                    c_in = (c_in - c_stats[0]) / c_stats[1]
                parts.append(c_in)
            n = u_in.shape[1]
            ones = torch.ones((b, n, 1), dtype=dtype, device=u_in.device)
            parts.append(ones * f[0][:, None, None])
            parts.append(ones * f[1][:, None, None])
            inputs = torch.cat(parts, dim=-1)
            if stepper == "output":
                target = (u_out - u_mean) / u_std
            elif stepper == "residual":
                target = (u_out - u_in - step_stats[0]) / step_stats[1]
            else:
                dt = f[2][:, None, None]
                target = ((u_out - u_in) / dt - step_stats[0]) / step_stats[1]
            batch = {"input": inputs.to(dtype), "target": target.to(dtype)}
            for k in extra:
                batch[k] = bufs[k].index_select(0, s_idx)
            return batch

        return bufs, assemble

    def device_get_batch(self, device):
        """The device route a batch at a time: ``get_batch(flat_idx)``
        sends the [B] sample indices over as one pinned copy and assembles
        the batch there (:meth:`device_parts`)."""
        bufs, assemble = self.device_parts(device)

        def get_batch(flat_idx):
            return assemble(bufs, to_device(np.asarray(flat_idx, dtype=np.int64), device))

        get_batch.device_epoch_spec = (bufs, assemble)
        return get_batch

    @property
    def row_selects(self) -> int:
        """``index_select`` calls (PyTorch's row gather) per device batch."""
        return 1 + (self.c is not None) + len(self.buffers)


def make_sequential_loader(batcher: DynamicPairBatcher, batch_size: int,
                           shuffle: bool = False, seed: int = 0,
                           device_data: bool = True, device="cuda") -> BatchLoader:
    """Batches of time pairs. Under ``device_data`` (and within
    :data:`~gaot_torch.data.loader.DEVICE_DATA_BYTE_LIMIT`) they are
    assembled on ``device`` (:meth:`DynamicPairBatcher.device_get_batch`),
    else on the host. On vx data each batch carries its ``vx_layout``,
    placed once. A device loader carries ``device_epoch_spec``, the
    buffers and the function that assembles a batch from them and an index
    tensor, the layout beside it."""
    nbytes = batcher.buffer_bytes()
    if device_data and nbytes <= DEVICE_DATA_BYTE_LIMIT:
        get_batch = batcher.device_get_batch(device)
        loader_device = device
    else:
        get_batch = batcher.get_batch
        loader_device = None
    layout = {}
    if batcher.buffers:
        layout = vx_layout(batcher.buffers, min(batch_size, len(batcher)),
                           batcher.num_latent)
        if loader_device is not None:
            layout = {k: torch.from_numpy(v).to(loader_device) for k, v in layout.items()}
    fetch = (lambda idx: {**get_batch(idx), **layout}) if layout else get_batch
    loader = BatchLoader(len(batcher), batch_size, fetch, shuffle=shuffle, seed=seed)
    loader.layout = layout
    loader.row_selects = batcher.row_selects if loader_device is not None else 0
    loader.host_reason = host_reason(device_data, nbytes)
    spec = getattr(get_batch, "device_epoch_spec", None)
    if spec is not None:
        bufs, assemble = spec
        loader.device_epoch_spec = (bufs, (lambda b, i: {**assemble(b, i), **layout})
                                    if layout else assemble)
    return loader


class RolloutTestBatcher:
    """Rollout-evaluation batches (the reference's TestDataset): the state
    at ``time_indices[0]`` with two zero time features, and the
    ground-truth sequence at ``time_indices[1:]`` ([B, T-1, N, V], not
    normalised). Host arrays."""

    def __init__(self, u_data: np.ndarray, c_data: Optional[np.ndarray],
                 time_indices: np.ndarray, stats: Dict, graphs=None):
        if graphs is not None:
            u_data, c_data = _vx_node_layout(graphs, u_data, c_data)
        self.u = u_data
        self.c = c_data
        self.time_indices = np.asarray(time_indices)
        self.stats = stats
        self.num_samples = u_data.shape[0]
        self.buffers = _sample_buffers(graphs) if graphs is not None else {}
        self.num_latent = graphs.num_latent if graphs is not None else None

    def __len__(self) -> int:
        return self.num_samples

    def get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        t0 = self.time_indices[0]
        u0 = self.u[idx, t0]                                     # [B, N, V]
        u_stats = self.stats["u"]
        feats = [(u0 - u_stats["mean"]) / u_stats["std"]]
        if self.c is not None:
            c0 = self.c[idx, t0]
            if "c" in self.stats:
                c0 = (c0 - self.stats["c"]["mean"]) / self.stats["c"]["std"]
            feats.append(c0)
        n = u0.shape[1]
        dummy = np.zeros((len(idx), n, 1), dtype=u0.dtype)
        feats.extend([dummy, dummy])
        batch = {
            "input": np.concatenate(feats, -1).astype(self.u.dtype),
            "target": self.u[idx][:, self.time_indices[1:]],    # [B, T-1, N, V]
        }
        for k, v in self.buffers.items():
            batch[k] = v[idx]
        return batch
