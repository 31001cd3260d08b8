"""The port's vx route (a mesh per sample) against the JAX package on the
CPU: the reduce with its two gradients, and the MAGNO and the whole GAOT.

- The reduce (``gaot_torch/ops/gather_apply.py::flat_gather_multiply_reduce``:
  forward, d_coef, d_f over the in-degree-grouped transpose graph) against
  ``jax.vjp`` of both JAX routes: the default coordinate-augmented one
  (``gather_rows_tg`` / ``gather_rows_bucketed_tg`` with the multiply-reduce
  left to XLA) and the one ``GAOT_AUG_GATHER=0`` selects
  (``gather_multiply_reduce_km`` / ``bucketed_gather_multiply_reduce``), on
  a dense flat graph and on a bucketed graph whose buckets differ in K;
  fp32 rtol 1e-4 / atol 1e-5.
- The GAOT, its MAGNO encoder and decoder included, at the shapes of
  ``tests/test_reference_parity_vx.py`` (batch 2, 90 nodes a sample, an
  8x8 grid), two scales with scale weights, bucketed, dense, and mixed
  (one scale bucketed, the other dense with its own transpose graph), the
  JAX side on both routes (``GAOT_AUG_GATHER`` set for it by monkeypatch):
  the forward at rtol 1e-4 / atol 1e-5 and every parameter's gradient
  within 1e-4 of its tensor's largest entry against ``jax.grad``, the JAX
  weights loaded strictly (``tests/torch_parity.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-4, 1e-5
B, N, GRID, C = 2, 90, 8, 8
SCALES = [1.0, 1.6]


def _lattice(n):
    ax = np.linspace(-1, 1, n)
    return np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)


def _split(bucketing: bool, scales=SCALES, seed=3, pad_multiple=8):
    """A vx split of B samples from the JAX builder, with its buffers."""
    from gaot_tpu.data.graph_builder import GraphBuilder, vx_graph_buffers

    x = np.random.default_rng(seed).uniform(-1, 1, (B, N, 2)).astype(np.float32)
    lat = _lattice(GRID)
    split = GraphBuilder(morton=True, pad_multiple=pad_multiple).build_all_vx_graphs(
        {"test": {"x": x}}, lat, 0.3, scales, build_train=False,
        with_transpose=True, bucketing=bucketing)["test"]
    bufs = vx_graph_buffers(split)
    bufs.pop("node_perm")
    return split, lat, bufs


def _graphs(bufs, jax_side: bool, num_scales=len(SCALES)):
    """JAX: the stacked (enc, dec, enc_t, dec_t); the port: the flat
    (enc, dec) of the batch with its layout."""
    if jax_side:
        from gaot_tpu.data.graph_builder import vx_batch_graphs

        return vx_batch_graphs({k: jnp.asarray(v) for k, v in bufs.items()}, num_scales)
    from gaot_torch.data.graph_builder import vx_flat_graphs, vx_layout

    batch = {**bufs, **vx_layout(bufs, B)}
    return vx_flat_graphs({k: torch.from_numpy(v) for k, v in batch.items()},
                          num_scales)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aug", [True, False], ids=["aug", "gather_off"])
@pytest.mark.parametrize("side", ["encoder", "decoder"])
@pytest.mark.parametrize("bucketing", [True, False], ids=["bucketed", "dense"])
def test_vx_reduce_matches_vjp(bucketing, side, aug):
    """out, d_coef of every bucket and d_f, held against one JAX route."""
    from gaot_torch.ops.gather_apply import flat_gather_multiply_reduce
    from gaot_tpu.models.magno import flatten_vx_bucketed, flatten_vx_graph
    from gaot_tpu.ops import gather_apply as jga

    split, lat, bufs = _split(bucketing)
    je, jd, jet, jdt = _graphs(bufs, True)
    te, td = _graphs(bufs, False)
    n_pad, q_lat = split.coords.shape[1], lat.shape[0]
    jg, vg = (je[0], te[0]) if side == "encoder" else (jd[0], td[0])
    jt = (jet or [None])[0] if side == "encoder" else (jdt or [None])[0]
    n_src = n_pad if side == "encoder" else q_lat
    ks = [g.indices.shape[1] for g in vg.buckets]
    if bucketing and side == "encoder":
        assert len(set(ks)) > 1, ks              # buckets of different K
    rng = np.random.default_rng(7)
    # Padded edges carry a zero coefficient, as the AGNO's fold makes them.
    coefs = [(rng.normal(size=(*g.indices.shape, C))
              * g.mask.numpy()[..., None]).astype(np.float32) for g in vg.buckets]
    f = rng.normal(size=(B * n_src, C)).astype(np.float32)
    ct = rng.normal(size=(B * vg.rows, C)).astype(np.float32)

    # The port's rows are sample-major [B, R]; the JAX flat bucketed layout
    # is bucket-major. The same buckets, each [B·R_j] sample-minor.
    rj = [g.indices.shape[0] // B for g in vg.buckets]
    base = np.concatenate([[0], np.cumsum(rj)])
    to_bm = np.concatenate([(np.arange(B)[:, None] * vg.rows + base[j]
                             + np.arange(rj[j])[None]).reshape(-1)
                            for j in range(len(rj))])
    if bucketing:
        flat = flatten_vx_bucketed(jg, n_src)
        jidx = tuple(g.indices for g in flat.buckets)
        for a, g in zip(jidx, vg.buckets):
            np.testing.assert_array_equal(np.asarray(a), g.indices.numpy())
        if aug:
            def jfn(cs, fv):
                gaths = jga.gather_rows_bucketed_tg(fv, jidx, flat.tgraph, B)
                return jnp.concatenate([(jnp.swapaxes(c, 0, 1) * gg).sum(0)
                                        for c, gg in zip(cs, gaths)], 0)
        else:
            def jfn(cs, fv):
                return jga.apply_bucketed_graph_transform(cs, fv, flat, B)
    else:
        flat = flatten_vx_graph(jg, n_src)
        idx_t = flat.indices.T
        if aug:
            def jfn(cs, fv):
                return (jnp.swapaxes(cs[0], 0, 1)
                        * jga.gather_rows_tg(fv, idx_t, jt, B)).sum(0)
        else:
            def jfn(cs, fv):
                return jga.gather_multiply_reduce_km(jnp.swapaxes(cs[0], 0, 1), fv,
                                                     idx_t, jt, B)
    out, vjp = jax.vjp(jax.jit(jfn), tuple(jnp.asarray(a) for a in coefs),
                       jnp.asarray(f))
    d_coefs, d_f = vjp(jnp.asarray(ct[to_bm]))

    cls = [torch.from_numpy(a).requires_grad_(True) for a in coefs]
    fl = torch.from_numpy(f).requires_grad_(True)
    got = flat_gather_multiply_reduce(cls, fl, vg)
    _close(got[torch.from_numpy(to_bm)], out)
    got.backward(torch.from_numpy(ct))
    for cl, want in zip(cls, d_coefs):
        _close(cl.grad, want)
    _close(fl.grad, d_f)


def test_vx_unpermute_matches_vjp():
    """The bucketed rows back to query order, and its gradient, against
    ``unpermute_rows`` on the JAX flat bucketed layout."""
    from gaot_torch.ops.gather_apply import permute_rows
    from gaot_tpu.models.magno import flatten_vx_bucketed
    from gaot_tpu.ops.gather_apply import unpermute_rows

    split, lat, bufs = _split(True)
    je, _, _, _ = _graphs(bufs, True)
    te, _ = _graphs(bufs, False)
    n_pad, q_lat = split.coords.shape[1], lat.shape[0]
    vg = te[0]
    flat = flatten_vx_bucketed(je[0], n_pad)
    rj = [g.indices.shape[0] // B for g in vg.buckets]
    base = np.concatenate([[0], np.cumsum(rj)])
    to_bm = np.concatenate([(np.arange(B)[:, None] * vg.rows + base[j]
                             + np.arange(rj[j])[None]).reshape(-1)
                            for j in range(len(rj))])
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B * vg.rows, C)).astype(np.float32)
    ct = rng.normal(size=(B * q_lat, C)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: unpermute_rows(a, flat.inv_perm, flat.perm,
                                                flat.row_valid), jnp.asarray(x[to_bm]))
    (dx,) = vjp(jnp.asarray(ct))
    xl = torch.from_numpy(x).requires_grad_(True)
    got = permute_rows(xl, vg.inv_perm, vg.perm, vg.row_valid)
    _close(got, out)
    got.backward(torch.from_numpy(ct))
    _close(xl.grad[torch.from_numpy(to_bm)], dx)


def _model_cfg(bucketing: bool, grid=GRID, scales=SCALES):
    return {"latent_tokens_size": [grid, grid],
            "args": {"magno": {"coord_dim": 2, "radius": 0.3, "hidden_size": 16,
                               "mlp_layers": 2, "lifting_channels": C,
                               "scales": scales, "use_scale_weights": True,
                               "use_query_bucketing": bucketing},
                     "transformer": {"patch_size": 2, "hidden_size": 16,
                                     "num_layers": 2,
                                     "attn_config": {"num_heads": 2,
                                                     "num_kv_heads": 2}}}}


# Layouts of the two scales: both bucketed, both dense, or mixed: at scale
# 0.7 with K padded to a multiple of 4 the decoder graph keeps K = 4 < 6
# and stays dense (with its own transpose graph) while the other three
# graphs are bucketed.
LAYOUTS = {"bucketed": (True, SCALES, 8), "dense": (False, SCALES, 8),
           "mixed": (True, [0.7, 1.6], 4)}


@pytest.mark.parametrize("aug", ["1", "0"], ids=["aug", "gather_off"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_vx_gaot_matches_jax(layout, aug, monkeypatch):
    """The whole vx GAOT (two scales, scale weights): forward, the masked
    loss, and every parameter's gradient."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.models import GAOT
    from gaot_torch.train.static_trainer import masked_mse
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict, load_flax_params
    from gaot_tpu.core.config import ModelConfig as JModelConfig
    from gaot_tpu.core.config import merge_config as jmerge
    from gaot_tpu.models import GAOT as JGAOT
    from gaot_tpu.train.static_trainer import masked_mse as jmasked_mse

    monkeypatch.setenv("GAOT_AUG_GATHER", aug)       # read by the JAX side only
    bucketing, scales, pad_multiple = LAYOUTS[layout]
    split, lat, bufs = _split(bucketing, scales, pad_multiple=pad_multiple)
    je, jd, jet, jdt = _graphs(bufs, True)
    te, td = _graphs(bufs, False)
    kinds = [type(g).__name__ == "BatchedBucketedGraph" for g in je + jd]
    assert kinds == ([True] * 4 if layout == "bucketed" else [False] * 4
                     if layout == "dense" else [True, True, False, True])
    assert all(g.tgraph is not None for g in te + td)
    rng = np.random.default_rng(5)
    n_pad = split.coords.shape[1]
    pn = rng.normal(size=(B, n_pad, 3)).astype(np.float32)
    tgt = rng.normal(size=(B, n_pad, 2)).astype(np.float32)
    jcfg = jmerge(JModelConfig, _model_cfg(bucketing, scales=scales))
    model = JGAOT(input_size=3, output_size=2, config=jcfg)
    args = (jnp.asarray(lat), jnp.asarray(split.coords), jnp.asarray(pn), je, jd)
    params = jax.jit(model.init)(jax.random.key(0), *args, encoder_tgraphs=jet,
                                 decoder_tgraphs=jdt)

    def jloss(p):
        pred = model.apply(p, *args, training=True, encoder_tgraphs=jet,
                           decoder_tgraphs=jdt)
        return jmasked_mse(pred, jnp.asarray(tgt), jnp.ones(B, bool),
                           jnp.asarray(split.node_mask)), pred

    (jl, jpred), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = GAOT(3, 2, merge_config(ModelConfig, _model_cfg(bucketing, scales=scales)),
              device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    pred = tm(torch.from_numpy(lat), torch.from_numpy(split.coords),
              torch.from_numpy(pn), te, td)
    loss = masked_mse(pred, torch.from_numpy(tgt), torch.ones(B, dtype=torch.bool),
                      torch.from_numpy(split.node_mask))
    _close(pred, jpred)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    loss.backward()
    ref = flax_to_torch_state_dict(jax.tree.map(np.asarray, jgrad))
    names = dict(tm.named_parameters())
    assert ref.keys() == names.keys()
    for k, p in names.items():
        err = np.abs(p.grad.numpy() - ref[k]).max()
        assert err <= 1e-4 * max(np.abs(ref[k]).max(), 1e-30), (k, err)
