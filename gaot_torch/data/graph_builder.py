"""Graph construction for the data pipeline (host NumPy).

- fx mode: one encoder graph (physical→latent) and one decoder graph
  (latent→physical) per scale, shared by every batch, from a radius or a
  k-nearest-neighbor search; :func:`prepare_fx_device_graphs` makes the
  same degree-bucketing decision as the JAX package and puts the graphs on
  a torch device.
- vx mode (a mesh per sample): per-sample graphs stacked to [S, Q, K]; the
  nodes of each sample Morton-ordered and padded to a common N with
  far-away sentinel coordinates (no neighbours within any radius) and a
  node mask; shared-layout degree buckets and in-degree-grouped transpose
  graphs chosen over all splits jointly (:meth:`GraphBuilder.
  build_all_vx_graphs`); a split serialised as a flat dict of per-sample
  arrays (:func:`vx_graph_buffers`), the loader's and the trainer's one key
  vocabulary.

Every layout and decision is the JAX package's, with its defaults as
constants: the vx bucketizer engages from K = 6 and the transpose graphs
are always grouped by in-degree.
"""
from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.gather_apply import FlatGraph
from ..ops.neighbor_search import knn_search, radius_search, resolve_method
from ..ops.padding import (
    BatchedBucketedGraph,
    GroupedTransposeGraph,
    PaddedGraph,
    TransposeGraph,
    _round_up,
    bucketize_graph,
    bucketize_graphs_stacked,
    degree_group_tgraph,
    graph_to_device,
    morton_order,
    pad_csr,
    repad,
    repad_tgraph,
    stack_graphs,
    stack_tgraphs,
    transpose_graph,
)
from ..utils.scaling import rescale

SENTINEL = 10.0   # a padded node's coordinate: farther than any radius in [-1, 1]
VX_MIN_BUCKET_K = 6   # the least dense K at which the vx bucketizer engages
NODE_PAD_MULTIPLE = 64   # vx node counts are padded to a multiple of this


@dataclass
class VxSplitGraphs:
    """One split's per-sample padded graphs and padded coordinates (vx)."""

    coords: np.ndarray          # [S, N_pad, d] model-space coords
    node_mask: np.ndarray       # [S, N_pad] True for real nodes
    encoder: list               # per scale, stacked [S, Q, K_enc] or bucketed
    decoder: list               # per scale, stacked [S, N_pad, K_dec] or bucketed
    encoder_t: Optional[list] = None  # per scale transpose graphs (dense scales)
    decoder_t: Optional[list] = None
    # Morton node order applied at the build: coords[i, j] is the original
    # node node_perm[i, j]; per-node data (u, c) must be permuted the same
    # way (apply_node_perm). None: build order kept.
    node_perm: Optional[np.ndarray] = None            # int32 [S, N]


def apply_node_perm(perm: Optional[np.ndarray], a: Optional[np.ndarray]):
    """Reorder a per-sample node-axis array to match Morton-ordered graphs.

    perm: int [S, N] (VxSplitGraphs.node_perm); a: [S, N, C] or
    [S, T, N, C] with the node axis at -2 (a longer node axis keeps its
    tail). No-op when either side is None."""
    if perm is None or a is None:
        return a
    s, n = perm.shape
    if a.shape[-2] < n:
        raise ValueError(f"node axis {a.shape[-2]} < perm width {n}")
    if a.shape[-2] > n:
        head = apply_node_perm(perm, a[..., :n, :])
        return np.concatenate([head, a[..., n:, :]], axis=-2)
    if a.ndim == 3:
        return a[np.arange(s)[:, None], perm]
    if a.ndim == 4:
        return a[np.arange(s)[:, None, None],
                 np.arange(a.shape[1])[None, :, None],
                 perm[:, None, :]]
    raise ValueError(f"unsupported ndim {a.ndim} for node permutation")


class GraphBuilder:
    """Builds padded radius or kNN graphs on the host; the per-sample vx
    searches run on up to eight threads (the native search releases the
    interpreter lock)."""

    def __init__(self, method: str = "auto", pad_multiple: int = 8,
                 neighbor_cap: Optional[int] = None, strategy: str = "radius",
                 knn_k: int = 16, morton: bool = False):
        if strategy not in ("radius", "knn"):
            raise ValueError(f"Unknown neighbor strategy: {strategy}")
        self.method = method
        self.pad_multiple = pad_multiple
        self.neighbor_cap = neighbor_cap
        self.strategy = strategy
        self.knn_k = knn_k
        self.morton = morton

    @classmethod
    def from_magno_config(cls, magno) -> "GraphBuilder":
        """Builder configured from a MAGNOConfig; the kNN k is
        ``max_neighbors``, or 16 where that is unset."""
        return cls(method=magno.neighbor_search_method,
                   pad_multiple=magno.neighbor_pad_multiple,
                   neighbor_cap=magno.neighbor_cap,
                   strategy=magno.neighbor_strategy,
                   knn_k=magno.max_neighbors or 16,
                   morton=magno.morton_ordering)

    @property
    def search_method(self) -> str:
        """The search method the builder runs on this host."""
        return resolve_method(self.method)

    def _search(self, data, queries, radius: float, scale: float = 1.0):
        """Radius or kNN search per the strategy; for 'knn' the scale
        multiplies k instead of the radius."""
        if self.strategy == "knn":
            k = max(1, int(round(self.knn_k * scale)))
            return knn_search(data, queries, k, method=self.method)
        return radius_search(data, queries, radius * scale, method=self.method)

    def _pad(self, csr) -> PaddedGraph:
        return pad_csr(*csr, pad_multiple=self.pad_multiple, cap=self.neighbor_cap)

    def build_fx_graphs(self, x_coord, latent_queries, radius: float,
                        scales: Sequence[float]):
        """One (encoder, decoder) padded graph pair per scale."""
        encoder, decoder = [], []
        for s in scales:
            encoder.append(self._pad(self._search(x_coord, latent_queries, radius, s)))
            decoder.append(self._pad(self._search(latent_queries, x_coord, radius, s)))
        return encoder, decoder

    def build_vx_split(self, x_data: np.ndarray, latent_queries: np.ndarray,
                       radius: float, scales: Sequence[float],
                       n_pad: Optional[int] = None,
                       model_transform=None) -> VxSplitGraphs:
        """Per-sample graphs of a whole split, stacked.

        x_data: [S, N, d] (or [S, 1, N, d]). Each sample's coordinates are
        rescaled to [-1, 1] for the search, while the coordinates handed to
        the model use ``model_transform`` (the dataset's coordinate
        scaler), by default the same rescale."""
        if x_data.ndim == 4:
            x_data = x_data[:, 0]
        num_samples, n, d = x_data.shape
        n_pad = n_pad or _round_up(n, NODE_PAD_MULTIPLE)
        coords = np.full((num_samples, n_pad, d), SENTINEL, dtype=np.float32)
        node_mask = np.zeros((num_samples, n_pad), dtype=bool)
        node_perm = (np.zeros((num_samples, n), dtype=np.int32)
                     if self.morton else None)

        def build_one(i):
            x_raw = np.asarray(x_data[i], dtype=np.float64)
            perm = None
            if self.morton:
                perm = morton_order(x_raw)
                x_raw = x_raw[perm]
            x = rescale(x_raw, (-1, 1))
            x_model = (model_transform(x_raw) if model_transform is not None
                       else x).astype(np.float32)
            enc, dec = [], []
            for s in scales:
                enc.append(self._pad(self._search(x, latent_queries, radius, s)))
                dg = self._pad(self._search(latent_queries, x, radius, s))
                pad_rows = n_pad - dg.indices.shape[0]   # one row per node
                dec.append(PaddedGraph(np.pad(dg.indices, ((0, pad_rows), (0, 0))),
                                       np.pad(dg.mask, ((0, pad_rows), (0, 0)))))
            return i, x_model, enc, dec, perm

        workers = min(8, os.cpu_count() or 1)
        if workers > 1 and num_samples > 1:
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                results = list(pool.map(build_one, range(num_samples)))
        else:
            results = [build_one(i) for i in range(num_samples)]
        enc_per = [None] * num_samples
        dec_per = [None] * num_samples
        for i, x_model, enc, dec, perm in results:
            coords[i, :n] = x_model
            node_mask[i, :n] = True
            enc_per[i], dec_per[i] = enc, dec
            if perm is not None:
                node_perm[i] = perm
        encoder = [stack_graphs([enc_per[i][s] for i in range(num_samples)])
                   for s in range(len(scales))]
        decoder = [stack_graphs([dec_per[i][s] for i in range(num_samples)])
                   for s in range(len(scales))]
        return VxSplitGraphs(coords=coords, node_mask=node_mask,
                             encoder=encoder, decoder=decoder, node_perm=node_perm)

    def build_all_vx_graphs(self, data_splits: Dict, latent_queries: np.ndarray,
                            radius: float, scales: Sequence[float],
                            build_train: bool = True, model_transform=None,
                            with_transpose: bool = False,
                            bucketing: bool = False) -> Dict[str, Optional[VxSplitGraphs]]:
        """vx graphs of every split with one shape across splits: one node
        padding, one K per scale and side, and (``bucketing``) one bucket
        layout and (``with_transpose``) one in-degree grouping chosen over
        all splits jointly."""
        split_names = ["test"] + (["train", "val"] if build_train else [])
        max_n = max((data_splits[s]["x"].shape[-2] for s in split_names
                     if s in data_splits), default=0)
        n_pad = _round_up(max_n, NODE_PAD_MULTIPLE)
        out: Dict[str, Optional[VxSplitGraphs]] = {"train": None, "val": None,
                                                  "test": None}
        for s in split_names:
            if s in data_splits and data_splits[s]["x"] is not None \
                    and len(data_splits[s]["x"]):
                out[s] = self.build_vx_split(
                    data_splits[s]["x"], latent_queries, radius, scales,
                    n_pad=n_pad, model_transform=model_transform)
        built = [g for g in out.values() if g is not None]
        if built:
            for si in range(len(scales)):
                k_enc = max(g.encoder[si].k for g in built)
                k_dec = max(g.decoder[si].k for g in built)
                for g in built:
                    g.encoder[si] = repad(g.encoder[si], k_enc)
                    g.decoder[si] = repad(g.decoder[si], k_dec)
            if bucketing:
                bucketize_vx_splits(built, latent_queries.shape[0], len(scales),
                                    with_transpose)
            if with_transpose:
                attach_transpose_graphs(built, latent_queries.shape[0], len(scales))
        return out


def _split_grouped(gt: GroupedTransposeGraph, sl: slice) -> GroupedTransposeGraph:
    """The samples ``sl`` of a stacked grouped transpose graph."""
    return GroupedTransposeGraph(
        tuple(g._replace(edge_pos=g.edge_pos[sl], query=g.query[sl], mask=g.mask[sl])
              for g in gt.groups), gt.inv_perm[sl])


def bucketize_vx_splits(built: List[VxSplitGraphs], q_lat: int,
                        num_scales: int, with_transpose: bool) -> None:
    """Degree-bucket every split's stacked graphs with one shared layout:
    the splits' samples are bucketized jointly (shared bucket Ks and row
    counts, the transpose graphs grouped jointly) and sliced back. A scale
    where bucketing does not pay keeps its dense PaddedGraph."""
    n_pad = built[0].coords.shape[1]

    def run(stacks: List[PaddedGraph], num_sources: int):
        cat = PaddedGraph(np.concatenate([g.indices for g in stacks], axis=0),
                          np.concatenate([g.mask for g in stacks], axis=0))
        bb = bucketize_graphs_stacked(cat, num_sources, with_transpose=with_transpose,
                                      min_k=VX_MIN_BUCKET_K)
        if bb is None:
            return None
        gt = degree_group_tgraph(bb.tgraph) if bb.tgraph is not None else None
        outs, off = [], 0
        for g in stacks:
            sl = slice(off, off + g.indices.shape[0])
            outs.append(bb._replace(
                buckets=tuple(PaddedGraph(b.indices[sl], b.mask[sl])
                              for b in bb.buckets),
                tgraph=_split_grouped(gt, sl) if gt is not None else None,
                perm=bb.perm[sl], inv_perm=bb.inv_perm[sl],
                row_valid=bb.row_valid[sl]))
            off = sl.stop
        return outs

    for si in range(num_scales):
        enc_b = run([g.encoder[si] for g in built], n_pad)
        if enc_b is not None:
            for g, bb in zip(built, enc_b):
                g.encoder[si] = bb
        dec_b = run([g.decoder[si] for g in built], q_lat)
        if dec_b is not None:
            for g, bb in zip(built, dec_b):
                g.decoder[si] = bb


def attach_transpose_graphs(built: List[VxSplitGraphs], q_lat: int,
                            num_scales: int) -> None:
    """Per-sample transpose graphs of the dense scales (bucketed scales
    carry their own), Kt unified and in-degree groups chosen over all
    splits jointly."""
    def tg_or_none(g, num_sources):
        if not isinstance(g, PaddedGraph):
            return None
        return stack_tgraphs([
            transpose_graph(PaddedGraph(g.indices[i], g.mask[i]), num_sources)
            for i in range(g.indices.shape[0])])

    for g in built:
        n_pad_g = g.coords.shape[1]
        g.encoder_t = [tg_or_none(e, n_pad_g) for e in g.encoder]
        g.decoder_t = [tg_or_none(d, q_lat) for d in g.decoder]

    def unify_and_group(side, si):
        stacks = [getattr(g, side)[si] for g in built]
        if stacks[0] is None:
            return
        kt = max(t.kt for t in stacks)
        stacks = [repad_tgraph(t, kt) for t in stacks]
        gt = degree_group_tgraph(TransposeGraph(
            np.concatenate([t.edge_pos for t in stacks], axis=0),
            np.concatenate([t.query for t in stacks], axis=0),
            np.concatenate([t.mask for t in stacks], axis=0)))
        off = 0
        for g, t in zip(built, stacks):
            sl = slice(off, off + t.edge_pos.shape[0])
            getattr(g, side)[si] = _split_grouped(gt, sl)
            off = sl.stop

    for si in range(num_scales):
        unify_and_group("encoder_t", si)
        unify_and_group("decoder_t", si)
    for g in built:
        if all(t is None for t in g.encoder_t):
            g.encoder_t = None
        if all(t is None for t in g.decoder_t):
            g.decoder_t = None


def vx_graph_buffers(graphs: VxSplitGraphs) -> Dict[str, np.ndarray]:
    """A VxSplitGraphs as a flat dict of per-sample arrays, the key
    vocabulary of the vx loader and of :func:`vx_batch_graphs`. Per scale s
    and side p in {enc, dec}:

    - dense:    {p}_idx_{s}, {p}_mask_{s};
    - bucketed: {p}_b{j}_idx_{s}, {p}_b{j}_mask_{s} per bucket j,
                {p}_perm_{s}, {p}_inv_{s}, {p}_rv_{s};
    - the transpose graph: {p}_tinv_{s} and {p}_tg{j}_pos_{s},
      {p}_tg{j}_q_{s}, {p}_tg{j}_mask_{s} per in-degree group j
      (flat: {p}_tpos_{s}, {p}_tq_{s}, {p}_tmask_{s}).
    """
    bufs = {"x": graphs.coords, "node_mask": graphs.node_mask}
    if graphs.node_perm is not None:
        bufs["node_perm"] = graphs.node_perm

    def put(p, s, g, tg):
        if isinstance(g, BatchedBucketedGraph):
            for j, b in enumerate(g.buckets):
                bufs[f"{p}_b{j}_idx_{s}"] = b.indices
                bufs[f"{p}_b{j}_mask_{s}"] = b.mask
            bufs[f"{p}_perm_{s}"] = g.perm
            bufs[f"{p}_inv_{s}"] = g.inv_perm
            bufs[f"{p}_rv_{s}"] = g.row_valid
            tg = g.tgraph
        else:
            bufs[f"{p}_idx_{s}"] = g.indices
            bufs[f"{p}_mask_{s}"] = g.mask
        if isinstance(tg, GroupedTransposeGraph):
            bufs[f"{p}_tinv_{s}"] = tg.inv_perm
            for j, gg in enumerate(tg.groups):
                bufs[f"{p}_tg{j}_pos_{s}"] = gg.edge_pos
                bufs[f"{p}_tg{j}_q_{s}"] = gg.query
                bufs[f"{p}_tg{j}_mask_{s}"] = gg.mask
        elif tg is not None:
            bufs[f"{p}_tpos_{s}"] = tg.edge_pos
            bufs[f"{p}_tq_{s}"] = tg.query
            bufs[f"{p}_tmask_{s}"] = tg.mask

    for s, g in enumerate(graphs.encoder):
        put("enc", s, g, graphs.encoder_t[s] if graphs.encoder_t else None)
    for s, g in enumerate(graphs.decoder):
        put("dec", s, g, graphs.decoder_t[s] if graphs.decoder_t else None)
    return bufs


def _graphs_from_keys(src: Dict, p: str, s: int):
    """(graph, separate transpose graph) of side p, scale s from a key
    dict; the arrays may be NumPy arrays or torch tensors."""
    def tg():
        if f"{p}_tinv_{s}" in src:
            groups, j = [], 0
            while f"{p}_tg{j}_pos_{s}" in src:
                groups.append(TransposeGraph(src[f"{p}_tg{j}_pos_{s}"],
                                             src[f"{p}_tg{j}_q_{s}"],
                                             src[f"{p}_tg{j}_mask_{s}"]))
                j += 1
            return GroupedTransposeGraph(tuple(groups), src[f"{p}_tinv_{s}"])
        if f"{p}_tpos_{s}" not in src:
            return None
        return TransposeGraph(src[f"{p}_tpos_{s}"], src[f"{p}_tq_{s}"],
                              src[f"{p}_tmask_{s}"])

    if f"{p}_b0_idx_{s}" in src:
        buckets, j = [], 0
        while f"{p}_b{j}_idx_{s}" in src:
            buckets.append(PaddedGraph(src[f"{p}_b{j}_idx_{s}"],
                                       src[f"{p}_b{j}_mask_{s}"]))
            j += 1
        return BatchedBucketedGraph(
            buckets=tuple(buckets), tgraph=tg(), perm=src[f"{p}_perm_{s}"],
            inv_perm=src[f"{p}_inv_{s}"], row_valid=src[f"{p}_rv_{s}"]), None
    return PaddedGraph(src[f"{p}_idx_{s}"], src[f"{p}_mask_{s}"]), tg()


def vx_batch_graphs(batch: Dict, num_scales: int):
    """Per-scale stacked vx graphs of a batch dict: (enc, dec, enc_t,
    dec_t). A t-list holds each scale's separate transpose graph (None for
    a bucketed scale, which embeds its own, or where none was built), and is
    None when no scale has one."""
    enc, enc_t, dec, dec_t = [], [], [], []
    for s in range(num_scales):
        g, t = _graphs_from_keys(batch, "enc", s)
        enc.append(g)
        enc_t.append(t)
        g, t = _graphs_from_keys(batch, "dec", s)
        dec.append(g)
        dec_t.append(t)
    return (enc, dec, None if all(t is None for t in enc_t) else enc_t,
            None if all(t is None for t in dec_t) else dec_t)


def vx_layout(bufs: Dict, batch_size: int) -> Dict[str, np.ndarray]:
    """The index arrays a vx batch of ``batch_size`` samples needs beside
    its samples' buffers, which depend on the layout alone (the buffers'
    shapes), not on the samples: ``iota`` (0, 1, ... as far as the batch,
    the padded nodes and the latent queries reach) and, per bucketed scale
    and side with more than one bucket, ``{p}_b{j}_rmap_{s}`` [B·R_j]: the
    row s·R + Σ_{i<j} R_i + r of bucket j's row r of sample s in the
    sample-major output. Made once where a split is placed."""
    out = {"iota": np.arange(max(batch_size, bufs["x"].shape[1], _num_latent(bufs)),
                             dtype=np.int32)}
    for key in bufs:
        if "_b0_idx_" not in key:
            continue
        p, s = key.split("_b0_idx_")
        rows, j = [], 0
        while f"{p}_b{j}_idx_{s}" in bufs:
            rows.append(bufs[f"{p}_b{j}_idx_{s}"].shape[1])
            j += 1
        if len(rows) == 1:
            continue
        dtype = bufs[key].dtype
        slot = np.arange(batch_size, dtype=dtype)[:, None] * sum(rows)
        for j, (base, rj) in enumerate(zip(np.cumsum([0] + rows), rows)):
            out[f"{p}_b{j}_rmap_{s}"] = (slot + base + np.arange(rj, dtype=dtype)
                                         ).reshape(-1).astype(dtype)
    return out


def _num_latent(batch: Dict) -> int:
    """The latent queries of a vx batch dict (the encoder's rows)."""
    return (batch["enc_inv_0"] if "enc_inv_0" in batch else batch["enc_idx_0"]).shape[1]


def _flatten(batch: Dict, p: str, s: int, num_sources: int,
             num_queries: int) -> FlatGraph:
    """One scale and side of a vx batch as one flat graph over the
    concatenated sources (the port's counterpart of ``flatten_vx_graph``
    and ``flatten_vx_bucketed``; sample-major where the JAX package lays
    the buckets out bucket-major): each per-sample id offset by its
    sample's slot, one add per index tensor."""
    graph, tgraph = _graphs_from_keys(batch, p, s)
    iota = batch["iota"]
    if isinstance(graph, BatchedBucketedGraph):
        b, r = graph.inv_perm.shape[0], sum(graph.bucket_rows)
        slot = iota[:b]
        buckets, row_maps = [], []
        for j, g in enumerate(graph.buckets):
            rj, k = g.indices.shape[1:]
            idx = torch.add(g.indices, slot[:, None, None], alpha=num_sources)
            buckets.append(PaddedGraph(idx.view(b * rj, k), g.mask.reshape(b * rj, k)))
            row_maps.append(batch.get(f"{p}_b{j}_rmap_{s}"))
        return FlatGraph(
            tuple(buckets), tuple(row_maps), r,
            torch.add(graph.perm, slot[:, None], alpha=num_queries).view(-1),
            torch.add(graph.inv_perm, slot[:, None], alpha=r).view(-1),
            graph.row_valid.reshape(-1), graph.tgraph, b, iota)
    if tgraph is not None and not isinstance(tgraph, GroupedTransposeGraph):
        raise NotImplementedError("vx batches take in-degree-grouped transpose "
                                  "graphs (build_all_vx_graphs)")
    b, q, k = graph.indices.shape
    idx = torch.add(graph.indices, iota[:b, None, None], alpha=num_sources)
    return FlatGraph((PaddedGraph(idx.view(b * q, k), graph.mask.reshape(b * q, k)),),
                     (None,), q, None, None, None, tgraph, b, iota)


def vx_flat_graphs(batch: Dict, num_scales: int):
    """The model's graphs of a placed vx batch (its buffers as tensors and
    its :func:`vx_layout`): (encoder, decoder), per scale a FlatGraph with
    its own transpose graph."""
    n_pad, q = batch["x"].shape[1], _num_latent(batch)
    return ([_flatten(batch, "enc", s, n_pad, q) for s in range(num_scales)],
            [_flatten(batch, "dec", s, q, n_pad) for s in range(num_scales)])


def vx_split_from_buffers(bufs: Dict[str, np.ndarray],
                          num_scales: int) -> VxSplitGraphs:
    """Inverse of :func:`vx_graph_buffers`."""
    enc, dec, enc_t, dec_t = vx_batch_graphs(bufs, num_scales)
    return VxSplitGraphs(coords=bufs["x"], node_mask=bufs["node_mask"],
                         encoder=enc, decoder=dec, encoder_t=enc_t,
                         decoder_t=dec_t, node_perm=bufs.get("node_perm"))


def prepare_fx_device_graphs(enc: List[PaddedGraph], dec: List[PaddedGraph],
                             num_nodes: int, num_latent: int, magno,
                             device="cuda") -> tuple:
    """Turn host fx graphs into model args on ``device``.

    Per scale:
    - ``magno.use_query_bucketing`` (linear transforms): re-pack into degree
      buckets when the padding win clears the threshold, with the combined
      transpose graph grouped by in-degree (the JAX package's default
      layout);
    - otherwise keep the dense PaddedGraph, with a separate transpose graph
      when ``magno.use_transpose_backward``.

    Returns (enc_graphs, dec_graphs, enc_tgraphs, dec_tgraphs); a tgraph
    list is None when no scale carries a separate transpose graph.
    """
    use_t = magno.use_transpose_backward
    bucketing = (magno.use_query_bucketing
                 and magno.transform_type in ("linear", "linear_kernelonly"))

    def prep(graphs, num_sources):
        out_g, out_t = [], []
        for g in graphs:
            bg = (bucketize_graph(g, num_sources, with_transpose=use_t)
                  if bucketing else None)
            if bg is not None:
                if bg.tgraph is not None:
                    gt = degree_group_tgraph(
                        TransposeGraph(bg.tgraph.edge_pos[None],
                                       bg.tgraph.query[None],
                                       bg.tgraph.mask[None]))
                    bg = bg._replace(tgraph=gt)
                out_g.append(graph_to_device(bg, device))
                out_t.append(None)
            else:
                out_g.append(graph_to_device(g, device))
                out_t.append(graph_to_device(transpose_graph(g, num_sources),
                                             device) if use_t else None)
        if all(t is None for t in out_t):
            out_t = None
        return out_g, out_t

    enc_g, enc_t = prep(enc, num_nodes)
    dec_g, dec_t = prep(dec, num_latent)
    return enc_g, dec_g, enc_t, dec_t
