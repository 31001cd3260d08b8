"""Batch iterators with static shapes (fx and vx).

Counterpart of ``gaot_tpu/data/loader.py``. The order of the samples is the
JAX package's, computed with the same NumPy calls:

- each epoch's order is ``default_rng(seed).permutation`` (shuffled) or
  ``arange``; every batch has the same shape: the final partial batch is
  padded by wrapping around (``np.resize(order, ...)``) and carries a
  ``sample_mask`` so losses and metrics ignore the padding;
- under ``device_data`` the split buffers go to the device once, up to
  :data:`DEVICE_DATA_BYTE_LIMIT`, and each batch is an ``index_select`` on
  the device by a [B] index tensor; above the limit, and without
  ``device_data``, batches are NumPy arrays that the trainer copies to the
  device (:class:`PrefetchLoader` does it on a worker thread).

A failure to place the data on the device raises: nothing falls back to
the host path.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

DEVICE_DATA_BYTE_LIMIT = 6 << 30  # above this, batches are assembled on the host


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A NumPy array as a tensor on ``device``; to a CUDA device through
    pinned memory with ``non_blocking=True``, so the copy does not wait for
    the device's queued work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class BatchLoader:
    """Iterates a dataset of S samples as fixed-size batches.

    ``get_batch(indices) -> dict`` is supplied by the dataset adapter; this
    class handles shuffling, batch padding, and the sample mask (a NumPy
    bool array in every batch).
    """

    def __init__(self, num_samples: int, batch_size: int,
                 get_batch: Callable[[np.ndarray], Dict],
                 shuffle: bool = False, seed: int = 0):
        self.num_samples = num_samples
        self.batch_size = min(batch_size, num_samples) if num_samples else batch_size
        self.get_batch = get_batch
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        return (self._rng.permutation(self.num_samples) if self.shuffle
                else np.arange(self.num_samples))

    def __iter__(self) -> Iterator[Dict]:
        order = self._epoch_order()
        bs = self.batch_size
        for start in range(0, self.num_samples, bs):
            chunk = order[start:start + bs]
            if len(chunk) < bs:
                pad = np.resize(order, bs - len(chunk))  # wrap-around padding
                mask = np.concatenate([np.ones(len(chunk), bool),
                                       np.zeros(bs - len(chunk), bool)])
                chunk = np.concatenate([chunk, pad])
            else:
                mask = np.ones(bs, dtype=bool)
            batch = self.get_batch(chunk)
            batch["sample_mask"] = mask
            yield batch


def _buffers_loader(buffers: Dict[str, np.ndarray], num_samples: int,
                    batch_size: int, shuffle: bool, seed: int,
                    device_data: bool, device,
                    layout: Optional[Dict[str, np.ndarray]] = None) -> BatchLoader:
    """Batches of the per-sample ``buffers``, each with the arrays of
    ``layout`` (the same in every batch) beside them."""
    layout = layout or {}
    if device_data and sum(v.nbytes for v in buffers.values()) <= DEVICE_DATA_BYTE_LIMIT:
        dev = {k: torch.from_numpy(v).to(device) for k, v in buffers.items()}
        dev_layout = {k: torch.from_numpy(v).to(device) for k, v in layout.items()}

        def get_batch(idx):
            i = to_device(idx, device)
            return {**{k: v.index_select(0, i) for k, v in dev.items()}, **dev_layout}
    else:
        def get_batch(idx):
            return {**{k: np.take(v, idx, axis=0) for k, v in buffers.items()}, **layout}
    loader = BatchLoader(num_samples, batch_size, get_batch, shuffle=shuffle,
                         seed=seed)
    loader.layout_keys = frozenset(layout)
    return loader


def make_static_fx_loader(c: Optional[np.ndarray], u: np.ndarray,
                          batch_size: int, shuffle: bool = False,
                          seed: int = 0, device_data: bool = True,
                          device="cuda") -> BatchLoader:
    """Loader for fixed-coordinate static data: batches of (c, u)."""
    buffers = {"u": u}
    if c is not None:
        buffers["c"] = c
    return _buffers_loader(buffers, len(u), batch_size, shuffle, seed,
                           device_data, device)


def make_static_vx_loader(c: Optional[np.ndarray], u: np.ndarray, graphs,
                          batch_size: int, shuffle: bool = False, seed: int = 0,
                          device_data: bool = True, device="cuda") -> BatchLoader:
    """Loader for variable-coordinate static data: batches of (c, u), the
    coordinates, the node mask and every graph buffer of the samples
    (``vx_graph_buffers`` keys), with the batch's ``vx_layout`` beside
    them, placed once. ``graphs`` is the split's VxSplitGraphs; u and c
    [S, N, ·] are put in the graphs' Morton node order, then padded with
    zero rows to the graphs' N_pad."""
    from .graph_builder import apply_node_perm, vx_graph_buffers, vx_layout

    n_pad = graphs.coords.shape[1]

    def pad_nodes(a):
        a = apply_node_perm(graphs.node_perm, a)
        if a.shape[1] == n_pad:
            return a
        return np.pad(a, ((0, 0), (0, n_pad - a.shape[1]), (0, 0)))

    buffers = {"u": pad_nodes(u), **vx_graph_buffers(graphs)}
    buffers.pop("node_perm", None)   # a record of the build, not a batch input
    if c is not None:
        buffers["c"] = pad_nodes(c)
    layout = vx_layout(buffers, min(batch_size, len(u)))
    return _buffers_loader(buffers, len(u), batch_size, shuffle, seed,
                           device_data, device, layout)


class PrefetchLoader:
    """Background-thread batch prefetch (double-buffered).

    Batch assembly, and with ``place_fn`` the copy to the device, run on a
    worker thread and overlap the step that consumes the previous batch.
    Iteration order and contents are identical to iterating the wrapped
    loader directly. An exception in the worker is raised in the consumer.
    """

    _DONE = object()
    _DEPTH = 2          # batches queued ahead of the consumer

    def __init__(self, loader, place_fn=None):
        self.loader = loader
        self.place_fn = place_fn

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self._DEPTH)
        err = []
        stop = threading.Event()

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    if self.place_fn is not None:
                        batch = self.place_fn(batch)
                    q.put(batch)
            except BaseException as e:  # raised again in the consumer thread
                err.append(e)
            finally:
                q.put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                yield item
        finally:
            # If the consumer abandons the iteration, let the worker finish:
            # drain the queue so it is not blocked on q.put.
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.01)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
