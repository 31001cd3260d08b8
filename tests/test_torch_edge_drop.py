"""Edge drop (``magno.sampling_strategy``) in the port against the JAX
package, on the CPU.

- The masks by their statistics (``gaot_torch/ops/edge_drop.py``): the keep
  rate of ``ratio``; under ``max_neighbors`` exactly min(valid degree, m)
  edges kept in each row, no padding slot, each valid edge about equally
  often; no draw at all where K <= m, at a ratio of 1 or more, without a
  generator or a strategy; the mask given never written.
- Results exactly: the port draws the masks with its generator and both
  sides get the dropped graphs; the JAX GAOT in evaluation on them is its
  training path with those masks. The forward and every parameter's
  gradient (masked MSE) against ``jax.grad`` at fp32, rtol 1e-5 and atol
  1e-5 of each tensor's largest entry, on fx dense and bucketed graphs and
  vx dense and bucketed ones, with the statistical embedding reading the
  thinned masks (a row that keeps no edge included); a training forward
  given the generator equals the evaluation forward on the masks that the
  same generator state draws.
- The fx route reads every slot of its graphs: a dropped neighbour's row
  may hold anything, as its coefficient is zero; the output and d_f do
  not move when it holds 1e30.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

RTOL = ATOL = 1e-5
GRID, N_FX, RADIUS, C = 32, 2000, 0.067, 8
B = 2
VX_N, VX_GRID, VX_RADIUS = 90, 8, 0.3
IN_CH, OUT_CH = 3, 2


def _lattice(n):
    ax = np.linspace(-1, 1, n)
    return np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)


def model_cfg(layout: str, grid: int, radius: float, **magno):
    return {"latent_tokens_size": [grid, grid],
            "args": {"magno": {"coord_dim": 2, "radius": radius, "hidden_size": 16,
                               "mlp_layers": 2, "lifting_channels": C,
                               "use_query_bucketing": layout.endswith("bucketed"),
                               **magno},
                     "transformer": {"patch_size": 2, "hidden_size": 16,
                                     "num_layers": 2,
                                     "attn_config": {"num_heads": 2,
                                                     "num_kv_heads": 2}}}}


def workload(layout: str, cfg: dict, seed: int = 0, twins: int = 0):
    """(coords, lattice, pndata, target, node mask or None, the JAX graphs
    (enc, dec, enc_t, dec_t), the port's graphs (enc, dec, enc_t, dec_t)).
    fx: each package builds its graphs from its own config; vx: the split
    that the JAX package's ``GraphBuilder`` makes, its buffers taken by both
    sides. The last ``twins``
    nodes (of each sample) sit on the first ``twins``."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_tpu.core.config import ModelConfig as JModelConfig
    from gaot_tpu.core.config import merge_config as jmerge

    rng = np.random.default_rng(seed)
    jm = jmerge(JModelConfig, cfg).args.magno
    tm = merge_config(ModelConfig, cfg).args.magno
    if layout.startswith("fx"):
        from gaot_torch.data import graph_builder as tgb
        from gaot_tpu.data import graph_builder as jgb

        # The nodes leave a corner of the domain empty: latent rows there
        # have no edge at all.
        coords = rng.uniform(-1, 0.7, (N_FX, 2)).astype(np.float32)
        if twins:
            coords[-twins:] = coords[:twins]
        lat = _lattice(cfg["latent_tokens_size"][0])
        n, q = coords.shape[0], lat.shape[0]
        je, jd = jgb.GraphBuilder.from_magno_config(jm).build_fx_graphs(
            coords, lat, jm.radius, jm.scales)
        te, td = tgb.GraphBuilder.from_magno_config(tm).build_fx_graphs(
            coords, lat, tm.radius, tm.scales)
        jgraphs = jgb.prepare_fx_device_graphs(je, jd, n, q, jm)
        tgraphs = tgb.prepare_fx_device_graphs(te, td, n, q, tm, device="cpu")
        nmask = None
    else:
        from gaot_torch.data.graph_builder import vx_flat_graphs, vx_layout
        from gaot_tpu.data.graph_builder import GraphBuilder, vx_batch_graphs, vx_graph_buffers

        x = rng.uniform(-1, 1, (B, VX_N, 2)).astype(np.float32)
        if twins:
            x[:, -twins:] = x[:, :twins]
        lat = _lattice(cfg["latent_tokens_size"][0])
        split = GraphBuilder(morton=True).build_all_vx_graphs(
            {"test": {"x": x}}, lat, jm.radius, jm.scales, build_train=False,
            with_transpose=jm.use_transpose_backward,
            bucketing=layout.endswith("bucketed"))["test"]
        bufs = vx_graph_buffers(split)
        bufs.pop("node_perm")
        jgraphs = vx_batch_graphs({k: jnp.asarray(v) for k, v in bufs.items()},
                                  len(jm.scales))
        batch = {**bufs, **vx_layout(bufs, B)}
        te, td = vx_flat_graphs({k: torch.from_numpy(v) for k, v in batch.items()},
                                len(tm.scales))
        tgraphs = (te, td, None, None)
        coords, nmask = split.coords, split.node_mask
    n = coords.shape[-2]
    pn = rng.normal(size=(B, n, IN_CH)).astype(np.float32)
    tgt = rng.normal(size=(B, n, OUT_CH)).astype(np.float32)
    return coords, lat, pn, tgt, nmask, jgraphs, tgraphs


def with_masks(jg, tg):
    """The JAX graph ``jg`` with the masks of the port's graph ``tg``: a
    PaddedGraph, the buckets of a BucketedGraph, or (vx) the stacked
    per-sample graph whose flattened masks the FlatGraph carries."""
    if hasattr(jg, "buckets"):
        return jg._replace(buckets=tuple(
            jb._replace(mask=jnp.asarray(tb.mask.numpy().reshape(jb.mask.shape)))
            for jb, tb in zip(jg.buckets, tg.buckets)))
    tmask = tg.buckets[0].mask if hasattr(tg, "buckets") else tg.mask
    return jg._replace(mask=jnp.asarray(tmask.numpy().reshape(jg.mask.shape)))


def jax_run(cfg, coords, lat, pn, tgt, nmask, jgraphs):
    """JAX's initial parameters, and its evaluation-mode forward and
    ``jax.grad`` of the masked MSE on ``jgraphs``."""
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.core.config import ModelConfig, merge_config
    from gaot_tpu.models import GAOT
    from gaot_tpu.train.static_trainer import masked_mse

    je, jd, jet, jdt = jgraphs
    model = GAOT(input_size=IN_CH, output_size=OUT_CH,
                 config=merge_config(ModelConfig, cfg))
    args = (jnp.asarray(lat), jnp.asarray(coords), jnp.asarray(pn), je, jd)
    kw = dict(encoder_tgraphs=jet, decoder_tgraphs=jdt)
    params = jax.jit(lambda key: model.init(key, *args, **kw))(jax.random.key(0))
    nm = None if nmask is None else jnp.asarray(nmask)

    def loss_fn(p):
        pred = model.apply(p, *args, training=False, **kw)
        return masked_mse(pred, jnp.asarray(tgt), jnp.ones(B, bool), nm), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    params, pred, grads = jax.tree.map(np.asarray, (params, pred, grads))
    return params, pred, flax_to_torch_state_dict(grads)


def torch_model(cfg, params):
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.models import GAOT
    from gaot_torch.utils.torch_interop import load_flax_params

    model = GAOT(IN_CH, OUT_CH, merge_config(ModelConfig, cfg), device="cpu")
    load_flax_params(model, params)
    return model.train()


def torch_run(model, coords, lat, pn, tgt, nmask, tgraphs, generator=None):
    """The port's training-mode forward and every parameter's gradient."""
    from gaot_torch.train.static_trainer import masked_mse

    model.zero_grad(set_to_none=True)
    te, td, tet, tdt = tgraphs
    pred = model(torch.from_numpy(lat), torch.from_numpy(coords), torch.from_numpy(pn),
                 te, td, encoder_tgraphs=tet, decoder_tgraphs=tdt, generator=generator)
    masked_mse(pred, torch.from_numpy(tgt), torch.ones(B, dtype=torch.bool),
               None if nmask is None else torch.from_numpy(nmask)).backward()
    return (pred.detach().numpy(),
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()})


def drop_graphs(model, tgraphs, generator):
    """The port's graphs with the masks the model's edge drop draws from
    ``generator``, in the forward's order: the encoder's scales, then the
    decoder's."""
    te, td, tet, tdt = tgraphs
    return ([model.encoder._drop_edges(g, generator) for g in te],
            [model.decoder._drop_edges(g, generator) for g in td], tet, tdt)


def assert_matches(pred, grads, want_pred, want):
    """The forward and each gradient within rtol 1e-5 and atol 1e-5 of the
    tensor's largest entry. The UViT's query and key projections are held
    by the largest entry of their attention block's four projections: their
    gradients pass through the softmax's sensitivity and cancel (as the
    dot-product attention's key bias in ``tests/test_torch_options.py``),
    so fp32 noise there reaches about 1e-5 of their own largest entry."""
    np.testing.assert_allclose(pred, want_pred, rtol=RTOL,
                               atol=ATOL * float(np.abs(want_pred).max()))
    assert grads.keys() == want.keys()
    for n in sorted(want):
        w = want[n].reshape(grads[n].shape)
        assert np.isfinite(grads[n]).all(), n
        ref = [n]
        if n.endswith(("attn.q_proj.weight", "attn.k_proj.weight")):
            block = n.rsplit(".", 2)[0]
            ref = [f"{block}.{p}_proj.weight" for p in "qkvo"]
        scale = max(float(np.abs(want[r]).max()) for r in ref)
        np.testing.assert_allclose(grads[n], w, rtol=RTOL, atol=ATOL * scale, err_msg=n)


def masks(graph):
    return [b.mask for b in graph.buckets] if hasattr(graph, "buckets") else [graph.mask]


# ----------------------------------------------------------------------
# The masks by their statistics.

def _prefix_mask(q=4000, k=24, seed=0):
    """[q, k] masks of valid prefixes (every degree 0..k) and holes."""
    deg = np.random.default_rng(seed).integers(0, k + 1, q)
    return torch.from_numpy(np.arange(k)[None] < deg[:, None])


def test_ratio_keeps_edges_at_its_rate():
    from gaot_torch.ops.edge_drop import apply_edge_drop_mask

    mask = _prefix_mask()
    gen = torch.Generator().manual_seed(1)
    out = apply_edge_drop_mask(mask, gen, "ratio", sample_ratio=0.3)
    assert out.dtype == torch.bool and out.is_contiguous()
    assert not (out & ~mask).any()                           # no padding slot
    n = int(mask.sum())
    rate = float(out.sum()) / n
    assert abs(rate - 0.3) <= 4 * np.sqrt(0.3 * 0.7 / n), rate
    assert not torch.equal(out, apply_edge_drop_mask(mask, gen, "ratio",
                                                     sample_ratio=0.3))


def test_max_neighbors_keeps_min_degree_m_uniformly():
    from gaot_torch.ops.edge_drop import apply_edge_drop_mask

    m, k = 6, 24
    mask = _prefix_mask(k=k)
    # Holes: a valid edge in the middle of each padded row.
    mask[::3, k // 2] = True
    gen = torch.Generator().manual_seed(2)
    out = apply_edge_drop_mask(mask, gen, "max_neighbors", max_neighbors=m)
    assert out.dtype == torch.bool and out.is_contiguous()
    assert not (out & ~mask).any()
    np.testing.assert_array_equal(out.sum(-1).numpy(),
                                  np.minimum(mask.sum(-1).numpy(), m))
    # Each valid edge of a full row is kept about equally often: m/k.
    full = torch.ones(20000, k, dtype=torch.bool)
    freq = apply_edge_drop_mask(full, gen, "max_neighbors",
                                max_neighbors=m).float().mean(0).numpy()
    p = m / k
    np.testing.assert_allclose(freq, p, atol=4 * np.sqrt(p * (1 - p) / 20000))


@pytest.mark.parametrize("case", ["k_le_m", "ratio_one", "no_generator", "no_strategy"])
def test_no_draw_leaves_the_mask(case):
    from gaot_torch.ops.edge_drop import apply_edge_drop_mask

    mask = _prefix_mask(q=64, k=8)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    args = {"k_le_m": (gen, "max_neighbors", 8, None),
            "ratio_one": (gen, "ratio", None, 1.0),
            "no_generator": (None, "ratio", None, 0.5),
            "no_strategy": (gen, None, 4, 0.5)}[case]
    assert apply_edge_drop_mask(mask, *args) is mask
    assert torch.equal(gen.get_state(), state)                # nothing drawn


def test_drop_writes_no_placed_mask():
    """The graphs placed once (fx, and the vx layout) stay as built: the
    model's drop returns new masks."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.models.magno import MAGNOEncoder

    cfg = model_cfg("fx_bucketed", GRID, RADIUS, sampling_strategy="ratio",
                    sample_ratio=0.5)
    _, _, _, _, _, _, tgraphs = workload("fx_bucketed", cfg)
    enc = tgraphs[0][0]
    before = [mk.clone() for mk in masks(enc)]
    magno = merge_config(ModelConfig, cfg).args.magno
    model = MAGNOEncoder(IN_CH, C, magno, C, device="cpu")
    dropped = model._drop_edges(enc, torch.Generator().manual_seed(0))
    assert type(dropped) is type(enc)
    for a, b, d in zip(masks(enc), before, masks(dropped)):
        assert torch.equal(a, b) and d is not a and not torch.equal(d, a)
    assert model._drop_edges(enc, None) is enc


# ----------------------------------------------------------------------
# Results exactly: both sides given the port's dropped masks.

CASES = {
    "fx_dense_ratio": ("fx_dense", {"sampling_strategy": "ratio", "sample_ratio": 0.4}),
    "fx_bucketed_max_neighbors": ("fx_bucketed", {"sampling_strategy": "max_neighbors",
                                                  "max_neighbors": 12}),
    "vx_dense_ratio": ("vx_dense", {"sampling_strategy": "ratio", "sample_ratio": 0.4}),
    "vx_bucketed_max_neighbors": ("vx_bucketed", {"sampling_strategy": "max_neighbors",
                                                  "max_neighbors": 8}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dropped_graphs_match_jax_fp32(name):
    layout, magno = CASES[name]
    vx = layout.startswith("vx")
    cfg = model_cfg(layout, VX_GRID if vx else GRID, VX_RADIUS if vx else RADIUS,
                    **magno)
    coords, lat, pn, tgt, nmask, jgraphs, tgraphs = workload(layout, cfg)
    # JAX's weights from its undropped graphs (the shapes are the same).
    params, _, _ = jax_run(cfg, coords, lat, pn, tgt, nmask, jgraphs)
    model = torch_model(cfg, params)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    dropped = drop_graphs(model, tgraphs, gen)

    # Something was thinned on both sides, and nothing grew.
    thinned = 0
    for before, after in zip(tgraphs[0] + tgraphs[1], dropped[0] + dropped[1]):
        for a, d in zip(masks(before), masks(after)):
            assert not (d & ~a).any()
            thinned += int(a.sum() - d.sum())
            if magno["sampling_strategy"] == "max_neighbors":
                np.testing.assert_array_equal(
                    d.sum(-1).numpy(),
                    np.minimum(a.sum(-1).numpy(), magno["max_neighbors"]))
    assert thinned > 0
    if magno["sampling_strategy"] == "ratio":
        # A row that had edges keeps none.
        assert any(bool((a.any(-1) & ~d.any(-1)).any())
                   for a, d in zip(masks(tgraphs[0][0]), masks(dropped[0][0])))

    jd = (*[[with_masks(j, t) for j, t in zip(jgraphs[i], dropped[i])]
            for i in (0, 1)], jgraphs[2], jgraphs[3])
    _, want_pred, want = jax_run(cfg, coords, lat, pn, tgt, nmask, jd)
    pred, grads = torch_run(model, coords, lat, pn, tgt, nmask, dropped)
    assert_matches(pred, grads, want_pred, want)

    # A training forward given the generator draws the same masks.
    gen.set_state(state)
    pred_g, grads_g = torch_run(model, coords, lat, pn, tgt, nmask, tgraphs, gen)
    np.testing.assert_array_equal(pred_g, pred)
    for n in grads:
        np.testing.assert_array_equal(grads_g[n], grads[n], err_msg=n)


# ----------------------------------------------------------------------
# A dropped neighbour's row is read, and weighs nothing.

@pytest.mark.parametrize("layout", ["fx_dense", "fx_bucketed"])
def test_dropped_rows_do_not_move_the_fx_route(layout):
    """The AGNO's fx route (the encoder's, over the transpose graph) on a
    dropped graph: the rows of the source nodes whose every edge was
    dropped hold 1e30, and the output and d_f stay the same bits."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.models.agno import AGNO
    from gaot_torch.models.magno import MAGNOEncoder

    cfg = model_cfg(layout, GRID, RADIUS, sampling_strategy="max_neighbors",
                    max_neighbors=4)
    coords, lat, _, _, _, _, tgraphs = workload(layout, cfg)
    magno = merge_config(ModelConfig, cfg).args.magno
    graph, tgraph = tgraphs[0][0], (tgraphs[2] or [None])[0]
    dropped = MAGNOEncoder(IN_CH, C, magno, C, device="cpu")._drop_edges(
        graph, torch.Generator().manual_seed(5))
    seen = torch.zeros(coords.shape[0], dtype=torch.bool)
    kept = torch.zeros_like(seen)
    for g, m_kept in zip(graph.buckets if hasattr(graph, "buckets") else [graph],
                         masks(dropped)):
        seen[g.indices[g.mask]] = True
        kept[g.indices[m_kept]] = True
    gone = torch.nonzero(seen & ~kept)[:, 0]
    assert len(gone) > 0
    torch.manual_seed(0)
    agno = AGNO(4, [16, C], coord_dim=2, use_attn=True)
    y, x = torch.from_numpy(coords), torch.from_numpy(lat)
    if hasattr(graph, "buckets"):
        x = x.index_select(0, graph.perm)
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.normal(size=(B, coords.shape[0], C)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(B, x.shape[0], C)).astype(np.float32))
    outs = []
    for value in (None, 1e30):
        fv = f.clone()
        if value is not None:
            fv[:, gone] = value
        fv.requires_grad_(True)
        out = agno(y, dropped, x=x, f_y=fv, tgraph=tgraph)
        out.backward(dout)
        outs.append((out.detach(), fv.grad))
    assert torch.isfinite(outs[1][0]).all()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not outs[1][1][:, gone].any()
