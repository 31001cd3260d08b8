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
