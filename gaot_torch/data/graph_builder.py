"""Graph construction for the fx data pipeline.

fx mode: one encoder graph (physical→latent) and one decoder graph
(latent→physical) per scale, shared by every batch, from a radius or a
k-nearest-neighbor search. The host builds padded NumPy graphs;
:func:`prepare_fx_device_graphs` makes the same degree-bucketing decision as
the JAX package and puts the graphs on a torch device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..ops.neighbor_search import knn_search, radius_search, resolve_method
from ..ops.padding import (
    PaddedGraph,
    TransposeGraph,
    bucketize_graph,
    degree_group_tgraph,
    graph_to_device,
    pad_csr,
    transpose_graph,
)


class GraphBuilder:
    """Builds padded radius or kNN graphs on the host."""

    def __init__(self, method: str = "auto", pad_multiple: int = 8,
                 neighbor_cap: Optional[int] = None, strategy: str = "radius",
                 knn_k: int = 16):
        if strategy not in ("radius", "knn"):
            raise ValueError(f"Unknown neighbor strategy: {strategy}")
        self.method = method
        self.pad_multiple = pad_multiple
        self.neighbor_cap = neighbor_cap
        self.strategy = strategy
        self.knn_k = knn_k

    @classmethod
    def from_magno_config(cls, magno) -> "GraphBuilder":
        """Builder configured from a MAGNOConfig; the kNN k is
        ``max_neighbors``, or 16 where that is unset."""
        return cls(method=magno.neighbor_search_method,
                   pad_multiple=magno.neighbor_pad_multiple,
                   neighbor_cap=magno.neighbor_cap,
                   strategy=magno.neighbor_strategy,
                   knn_k=magno.max_neighbors or 16)

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
