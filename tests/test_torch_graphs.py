"""The port's fx graph pipeline against gaot_tpu's: build_fx_graphs and
prepare_fx_device_graphs must give exactly the same arrays — indices,
masks, bucket shapes, perm / inv_perm / row_valid and the (grouped)
transpose graphs — on a point cloud whose encoder graph buckets and whose
decoder graph stays dense, as on the main path."""
import numpy as np
import pytest

import torch_parity as tp


@pytest.mark.parametrize("method", ["auto", "kdtree"])
def test_fx_graphs_identical(method):
    from gaot_torch.data.graph_builder import GraphBuilder
    from gaot_torch.data.graph_builder import prepare_fx_device_graphs
    from gaot_tpu.data.graph_builder import GraphBuilder as JGraphBuilder
    from gaot_tpu.data.graph_builder import (
        prepare_fx_device_graphs as jprepare)

    coords, lat, _, _ = tp.workload()
    jcfg, tcfg = tp.configs()
    jenc, jdec = JGraphBuilder(method=method).build_fx_graphs(
        coords, lat, tp.RADIUS, [1.0])
    builder = GraphBuilder(method=method)
    tenc, tdec = builder.build_fx_graphs(coords, lat, tp.RADIUS, [1.0])
    for a, b in zip(jenc + jdec, tenc + tdec):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.mask, b.mask)
    assert builder.search_method in ("cpp", "kdtree")

    jout = jprepare(jenc, jdec, tp.NUM_NODES, lat.shape[0], jcfg.args.magno)
    tout = prepare_fx_device_graphs(tenc, tdec, tp.NUM_NODES, lat.shape[0],
                                    tcfg.args.magno, device="cpu")
    for name, j, t in zip(("enc", "dec", "enc_t", "dec_t"), jout, tout):
        tp.assert_same_graphs(j, t, name)

    enc, dec, enc_t, dec_t = tout
    # The main path's layout: bucketed encoder with an in-degree-grouped
    # transpose graph, dense decoder (K < 12) with its transpose graph.
    assert type(enc[0]).__name__ == "BucketedGraph" and len(enc[0].buckets) > 1
    assert type(enc[0].tgraph).__name__ == "GroupedTransposeGraph"
    assert enc_t is None
    assert type(dec[0]).__name__ == "PaddedGraph" and dec[0].indices.shape[1] < 12
    assert type(dec_t[0]).__name__ == "TransposeGraph"


def test_dense_layout_when_bucketing_off():
    from gaot_torch.data.graph_builder import GraphBuilder
    from gaot_torch.data.graph_builder import prepare_fx_device_graphs
    from gaot_tpu.data.graph_builder import (
        prepare_fx_device_graphs as jprepare)

    coords, lat, _, _ = tp.workload()
    jcfg, tcfg = tp.configs()
    jcfg.args.magno.use_query_bucketing = False
    tcfg.args.magno.use_query_bucketing = False
    enc, dec = GraphBuilder().build_fx_graphs(coords, lat, tp.RADIUS, [1.0])
    jout = jprepare(enc, dec, tp.NUM_NODES, lat.shape[0], jcfg.args.magno)
    tout = prepare_fx_device_graphs(enc, dec, tp.NUM_NODES, lat.shape[0],
                                    tcfg.args.magno, device="cpu")
    for name, j, t in zip(("enc", "dec", "enc_t", "dec_t"), jout, tout):
        tp.assert_same_graphs(j, t, name)


@pytest.mark.parametrize("dim", [2, 3])
def test_grid_radius_search_matches_jax_and_kdtree(dim):
    """``neighbor_search_method: "grid"``: the CSR of the port's NumPy
    spatial hash equals gaot_tpu's ``grid`` bit for bit, and the port's
    ``kdtree`` up to the order within a row (the hash lists a row's
    neighbours cell by cell, scipy by index; JAX's ``grid`` does the same)."""
    from gaot_torch.ops.neighbor_search import radius_search
    from gaot_tpu.ops.neighbor_search import radius_search as jradius_search

    rng = np.random.default_rng(dim)
    data = rng.uniform(-1, 1, (500, dim)).astype(np.float32)
    # Queries beyond the data's cells too: rows without a neighbour.
    queries = np.concatenate([rng.uniform(-1.1, 1.1, (50, dim)),
                              np.full((2, dim), 3.0)]).astype(np.float32)
    radius = 0.2 if dim == 2 else 0.35
    idx, splits = radius_search(data, queries, radius, method="grid")
    jidx, jsplits = jradius_search(data, queries, radius, method="grid")
    assert idx.dtype == jidx.dtype == splits.dtype == jsplits.dtype == np.int64
    np.testing.assert_array_equal(splits, jsplits)
    np.testing.assert_array_equal(idx, jidx)
    kidx, ksplits = radius_search(data, queries, radius, method="kdtree")
    np.testing.assert_array_equal(splits, ksplits)
    assert splits[-1] > 0 and (np.diff(splits) == 0).any()
    for a, b in zip(np.split(idx, splits[1:-1]), np.split(kidx, ksplits[1:-1])):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_fit_with_grid_search(tmp_path):
    """A fx fit whose graphs come from the grid search, on the CPU."""
    from gaot_torch.train import StaticTrainer
    from test_torch_trainer import _config

    cfg = _config(tmp_path, "grid")
    cfg["model"]["args"]["magno"]["neighbor_search_method"] = "grid"
    trainer = StaticTrainer(cfg)
    trainer.fit(verbose=False)
    rec = np.load(tmp_path / "grid_loss.npz")
    assert np.isfinite(rec["losses"]).all()
    assert np.isfinite(trainer.datarow["relative error (direct)"])
