"""The port's 3D path against gaot_tpu on the CPU: kNN graphs, the tiny 3D
kNN GAOT (forward and every gradient), the closed-form 3x3 eigenvalues on
near-degenerate neighbourhoods, the dense transpose-graph route at a large
fan-in, and the two routing repairs the 3D flagship needs (flash attention
at head dim 24, the SwiGLU routed by the JAX package's gate).

The tiny model is the flagship (``scripts/train_demo.py::run_3d``) cut to
size: an 8³ latent grid at patch 2 (64 tokens), 600 nodes in [-1, 1]³, kNN
graphs with k = 4 (padded to K = 8), MAGNO hidden 16, a 3-layer UViT of
hidden 48 with 2 heads of dim 24, JAX weights carried over by
``load_flax_params``. Its latent lattice has a different spacing on each
axis. On a cubic lattice the 4 nearest lattice points of every node are a
square, whose covariance has two equal eigenvalues; the closed-form solver's
rounding there (about 3e-6) sits at the 1e-6 floor of the embedding's
standardisation, and the JAX package's own jitted and op-by-op runs then
disagree by O(1) in the decoder's embedding (the port agrees with the
op-by-op run to 1e-6).

Tolerances: fp32 forward rtol 1e-4 / atol 1e-5 and fp32 gradients rtol 1e-4
/ atol 1e-5 of each tensor's largest entry (fp32 arithmetic in another
order); bf16 gradients a global relative L2 of 5e-2 and the loss 2e-2
(bf16 rounds at other places in XLA and PyTorch).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

GRID = (8, 8, 8)
NUM_NODES = 600
BATCH = 2
IN_CH, OUT_CH = 2, 1

MODEL_CFG = {
    "latent_tokens_size": list(GRID),
    "args": {
        "magno": {"coord_dim": 3, "radius": 0.05, "hidden_size": 16,
                  "mlp_layers": 2, "lifting_channels": 8,
                  "neighbor_strategy": "knn", "max_neighbors": 4},
        "transformer": {"patch_size": 2, "hidden_size": 48, "num_layers": 3,
                        "attn_config": {"num_heads": 2, "num_kv_heads": 2}},
    },
}


def _lattice(n: int, dim: int) -> np.ndarray:
    ax = np.linspace(-1, 1, n)
    grid = np.meshgrid(*([ax] * dim), indexing="ij")
    return np.stack(grid, -1).reshape(-1, dim).astype(np.float32)


def _workload(seed: int = 0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (NUM_NODES, 3)).astype(np.float32)
    pndata = rng.normal(size=(BATCH, NUM_NODES, IN_CH)).astype(np.float32)
    target = rng.normal(size=(BATCH, NUM_NODES, OUT_CH)).astype(np.float32)
    lat = _lattice(GRID[0], 3) * np.array([1.0, 0.85, 0.7], np.float32)
    return coords, lat, pndata, target


def _configs():
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_tpu.core.config import ModelConfig as JModelConfig
    from gaot_tpu.core.config import merge_config as jmerge

    return jmerge(JModelConfig, MODEL_CFG), merge_config(ModelConfig, MODEL_CFG)


def _graphs(coords, lat, magno, port: bool):
    """(enc, dec, enc_t, dec_t) from the JAX package's or the port's builder,
    configured from the model's MAGNO config."""
    if port:
        from gaot_torch.data.graph_builder import GraphBuilder, prepare_fx_device_graphs

        kw = {"device": "cpu"}
    else:
        from gaot_tpu.data.graph_builder import GraphBuilder, prepare_fx_device_graphs

        kw = {}
    enc, dec = GraphBuilder.from_magno_config(magno).build_fx_graphs(
        coords, lat, magno.radius, magno.scales)
    return prepare_fx_device_graphs(enc, dec, coords.shape[0], lat.shape[0],
                                    magno, **kw)


@functools.lru_cache(maxsize=None)
def _jax_params():
    from gaot_tpu.models import GAOT as JGAOT

    coords, lat, pndata, _ = _workload()
    jcfg, _ = _configs()
    enc, dec, enc_t, dec_t = _graphs(coords, lat, jcfg.args.magno, port=False)
    model = JGAOT(input_size=IN_CH, output_size=OUT_CH, config=jcfg)
    params = jax.jit(model.init)(jax.random.key(0), jnp.asarray(lat),
                                 jnp.asarray(coords), jnp.asarray(pndata),
                                 enc, dec, encoder_tgraphs=enc_t,
                                 decoder_tgraphs=dec_t)
    return jax.tree.map(np.asarray, params)


def _jax_loss_and_grads(dtype):
    """JAX prediction, masked-MSE loss and its gradients by state-dict name."""
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.models import GAOT as JGAOT
    from gaot_tpu.train.static_trainer import masked_mse

    coords, lat, pndata, target = _workload()
    jcfg, _ = _configs()
    enc, dec, enc_t, dec_t = _graphs(coords, lat, jcfg.args.magno, port=False)
    model = JGAOT(input_size=IN_CH, output_size=OUT_CH, config=jcfg, dtype=dtype)
    smask = jnp.ones(BATCH, bool)
    key = jax.random.key(0)

    def loss_fn(p):
        pred = model.apply(p, jnp.asarray(lat), jnp.asarray(coords),
                           jnp.asarray(pndata), enc, dec, training=True,
                           rngs={"dropout": key, "edge_drop": key},
                           encoder_tgraphs=enc_t, decoder_tgraphs=dec_t)
        return masked_mse(pred, jnp.asarray(target), smask), pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_params())
    return (np.asarray(pred.astype(jnp.float32)), float(loss),
            flax_to_torch_state_dict(jax.tree.map(np.asarray, grads)))


def _torch_loss_and_grads(dtype):
    from gaot_torch.models import GAOT
    from gaot_torch.train.static_trainer import FxGraphs, masked_mse
    from gaot_torch.utils.torch_interop import load_flax_params

    coords, lat, pndata, target = _workload()
    _, tcfg = _configs()
    graphs = FxGraphs(torch.from_numpy(lat),
                      *_graphs(coords, lat, tcfg.args.magno, port=True))
    model = GAOT(IN_CH, OUT_CH, tcfg, dtype=dtype, device="cpu")
    load_flax_params(model, _jax_params())
    model.train()
    pred = model(graphs.latent_tokens_coord, torch.from_numpy(coords),
                 torch.from_numpy(pndata), graphs.encoder, graphs.decoder,
                 encoder_tgraphs=graphs.encoder_t, decoder_tgraphs=graphs.decoder_t)
    loss = masked_mse(pred, torch.from_numpy(target), torch.ones(BATCH, dtype=torch.bool))
    loss.backward()
    return (tp.to_np(pred), float(loss.detach()),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


@pytest.mark.parametrize("method", ["cpp", "kdtree"])
@pytest.mark.parametrize("dim", [2, 3])
def test_knn_graphs_identical(method, dim):
    """The CSR of ``knn_search``, the padded graphs of two scales (k = 5 and
    10, padded to K = 8 and 16) and the device graphs, against gaot_tpu's."""
    from gaot_torch.data.graph_builder import GraphBuilder, prepare_fx_device_graphs
    from gaot_torch.ops.neighbor_search import knn_search
    from gaot_tpu.data.graph_builder import GraphBuilder as JGraphBuilder
    from gaot_tpu.data.graph_builder import prepare_fx_device_graphs as jprepare
    from gaot_tpu.ops.neighbor_search import knn_search as jknn

    rng = np.random.default_rng(dim)
    nodes = rng.uniform(-1, 1, (700, dim)).astype(np.float32)
    lat = _lattice(16 if dim == 2 else 7, dim)
    for data, queries in ((nodes, lat), (lat, nodes)):
        got, want = knn_search(data, queries, 5, method), jknn(data, queries, 5, method)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert np.all(np.diff(got[1]) == 5)
    kw = dict(method=method, strategy="knn", knn_k=5)
    tenc, tdec = GraphBuilder(**kw).build_fx_graphs(nodes, lat, 0.1, [1.0, 2.0])
    jenc, jdec = JGraphBuilder(**kw).build_fx_graphs(nodes, lat, 0.1, [1.0, 2.0])
    for a, b in zip(jenc + jdec, tenc + tdec):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.mask, b.mask)
    assert [g.indices.shape[1] for g in tenc] == [8, 16]
    assert [int(g.mask.sum(1).max()) for g in tenc] == [5, 10]

    jcfg, tcfg = _configs()
    jout = jprepare(jenc, jdec, len(nodes), len(lat), jcfg.args.magno)
    tout = prepare_fx_device_graphs(tenc, tdec, len(nodes), len(lat),
                                    tcfg.args.magno, device="cpu")
    for name, j, t in zip(("enc", "dec", "enc_t", "dec_t"), jout, tout):
        tp.assert_same_graphs(j, t, name)
    # K = 8 < 12 keeps the dense layout and a flat transpose graph (the
    # flagship's); k = 10 padded to 16 buckets, as gaot_tpu decides.
    assert [type(g).__name__ for g in tout[0]] == ["PaddedGraph", "BucketedGraph"]
    assert type(tout[1][0]).__name__ == "PaddedGraph"
    assert type(tout[2][0]).__name__ == type(tout[3][0]).__name__ == "TransposeGraph"


def test_knn_search_caps_k_and_rejects_unknown_methods():
    from gaot_torch.ops.neighbor_search import knn_search

    data = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 2.0, 0.0]], np.float32)
    queries = np.zeros((4, 3), np.float32)
    for method in ("cpp", "kdtree"):
        idx, splits = knn_search(data, queries, 8, method)
        np.testing.assert_array_equal(splits, np.arange(5) * 3)
        np.testing.assert_array_equal(idx.reshape(4, 3), [[0, 1, 2]] * 4)
    with pytest.raises(ValueError, match="Unknown kNN"):
        knn_search(data, queries, 2, "grid")
    with pytest.raises(RuntimeError, match="2D/3D"):
        knn_search(np.zeros((5, 4), np.float32), np.zeros((2, 4), np.float32), 2, "cpp")


def test_eigvalsh_3x3_near_degenerate_matches_jax():
    """Covariances of few or nearly collinear / coplanar neighbours, scalar
    and near-scalar matrices, and repeated eigenvalues: the port's
    closed-form eigenvalues against gaot_tpu's (fp32, within 2e-6 of each
    matrix's largest eigenvalue) and against float64 ``eigvalsh`` (the
    trigonometric method loses digits where two eigenvalues meet, so 2e-3
    of the largest there)."""
    from gaot_torch.models.gemb import eigvalsh_3x3
    from gaot_tpu.models.gemb import eigvalsh_3x3 as jeig

    rng = np.random.default_rng(3)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    covs = []
    for n_pts in (2, 3, 4):                    # few neighbours
        p = rng.normal(size=(n_pts, 3))
        covs.append(np.cov(p.T, bias=True))
    line = rng.normal(size=(1, 3)) * rng.normal(size=(8, 1))
    covs.append(np.cov((line + 1e-4 * rng.normal(size=(8, 3))).T, bias=True))
    plane = rng.normal(size=(8, 2)) @ rng.normal(size=(2, 3))
    covs.append(np.cov((plane + 1e-4 * rng.normal(size=(8, 3))).T, bias=True))
    covs += [np.eye(3) * 0.3, np.diag([0.3, 0.3 + 1e-7, 0.3]),
             rot @ np.diag([2.0, 1.0, 1.0]) @ rot.T,
             rot @ np.diag([1.0, 1.0, 1e-6]) @ rot.T, np.zeros((3, 3))]
    covs = np.stack(covs).astype(np.float32)
    got = eigvalsh_3x3(torch.from_numpy(covs)).numpy()
    want = np.asarray(jeig(jnp.asarray(covs)))
    exact = np.linalg.eigvalsh(covs.astype(np.float64))[:, ::-1]
    top = np.abs(exact).max(1, keepdims=True)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 2e-6 * top + 1e-12).all()
    assert (np.abs(got - exact) <= 2e-3 * top + 1e-12).all()


def test_dense_transpose_route_large_fan_in_matches_vjp():
    """The dense kNN encoder route where each node is reached by about 500
    latent queries (a 16³ grid onto 64 nodes, k = 8): the forward, d_coef
    and d_f through the transpose graph against ``jax.vjp`` (fp32 rtol 1e-5,
    atol 1e-4 for sums of about 500 terms)."""
    from gaot_torch.data.graph_builder import GraphBuilder
    from gaot_torch.ops.gather_apply import gather_multiply_reduce_nbc
    from gaot_torch.ops.padding import graph_to_device, transpose_graph
    from gaot_tpu.ops.gather_apply import gather_multiply_reduce_nbc as jgmr
    from gaot_tpu.ops.padding import transpose_graph as jtranspose

    rng = np.random.default_rng(9)
    nodes = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    lat = _lattice(16, 3)
    enc, _ = GraphBuilder(strategy="knn", knn_k=8).build_fx_graphs(nodes, lat, 0.0, [1.0])
    g = enc[0]
    jt, tt = jtranspose(g, len(nodes)), graph_to_device(transpose_graph(g, len(nodes)), "cpu")
    assert tt.mask.shape[1] >= 256 and float(tt.mask.sum(1).float().mean()) == 512.0
    q, k = g.indices.shape
    coef = rng.normal(size=(q, k, 4)).astype(np.float32)
    f = rng.normal(size=(len(nodes), BATCH, 4)).astype(np.float32)
    ct = rng.normal(size=(q, BATCH, 4)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jgmr(a, b, jnp.asarray(g.indices), jt.edge_pos,
                                         jt.query, jt.mask),
                       jnp.asarray(coef), jnp.asarray(f))
    d_coef, d_f = vjp(jnp.asarray(ct))
    cl, fl = (torch.from_numpy(a).requires_grad_(True) for a in (coef, f))
    got = gather_multiply_reduce_nbc(cl, fl, torch.from_numpy(g.indices).long(),
                                     tt.edge_pos, tt.query, tt.mask)
    got.backward(torch.from_numpy(ct))
    for a, b in ((got, out), (cl.grad, d_coef), (fl.grad, d_f)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


def test_tiny_3d_gaot_forward_fp32_matches_jax():
    from gaot_torch.models import GAOT
    from gaot_torch.train.static_trainer import FxGraphs, eval_step
    from gaot_torch.utils.torch_interop import load_flax_params
    from gaot_tpu.models import GAOT as JGAOT

    coords, lat, pndata, target = _workload()
    jcfg, tcfg = _configs()
    jg = _graphs(coords, lat, jcfg.args.magno, port=False)
    model = JGAOT(input_size=IN_CH, output_size=OUT_CH, config=jcfg)
    want = np.asarray(jax.jit(model.apply)(
        _jax_params(), jnp.asarray(lat), jnp.asarray(coords), jnp.asarray(pndata),
        jg[0], jg[1], encoder_tgraphs=jg[2], decoder_tgraphs=jg[3]))
    graphs = FxGraphs(torch.from_numpy(lat),
                      *_graphs(coords, lat, tcfg.args.magno, port=True))
    tmodel = GAOT(IN_CH, OUT_CH, tcfg, device="cpu")
    load_flax_params(tmodel, _jax_params())
    got, _ = eval_step(tmodel.eval(), graphs, torch.from_numpy(coords),
                       torch.from_numpy(pndata), torch.from_numpy(target),
                       torch.ones(BATCH, dtype=torch.bool))
    assert tmodel.processor.encoder_layers[0].attn.head_dim == 24
    assert got.shape == want.shape == (BATCH, NUM_NODES, OUT_CH)
    np.testing.assert_allclose(tp.to_np(got), want, rtol=1e-4, atol=1e-5)


def test_tiny_3d_gaot_gradients_fp32_match_jax_grad():
    want_pred, want_loss, want = _jax_loss_and_grads(None)
    pred, loss, got = _torch_loss_and_grads(None)
    assert set(got) == set(want)
    np.testing.assert_allclose(pred, want_pred, rtol=1e-4, atol=1e-5)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for name in sorted(want):
        w = want[name].reshape(got[name].shape)
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_tiny_3d_gaot_gradients_bf16_match_jax_grad():
    _, want_loss, want = _jax_loss_and_grads(jnp.bfloat16)
    _, loss, got = _torch_loss_and_grads(torch.bfloat16)
    assert set(got) == set(want)
    assert loss == pytest.approx(want_loss, rel=2e-2)
    g = np.concatenate([got[n].reshape(-1) for n in sorted(want)])
    w = np.concatenate([want[n].reshape(-1) for n in sorted(want)])
    assert np.isfinite(g).all()
    assert tp.rel_l2(g, w) <= 5e-2


@pytest.mark.parametrize("m", [128, 192, 256])
def test_ffn_routes_by_the_jax_gate(m):
    """The port's FFN takes the fused kernel's wrapper exactly where the JAX
    package's gate accepts the shape (bf16 under "auto", any dtype under
    "on"); the flagship's M = 192 takes the plain three products."""
    from gaot_torch.models.transformer import FFN
    from gaot_tpu.ops.pallas.fused_ffn import supported

    x = torch.zeros(2, 64, m, dtype=torch.bfloat16)
    for mode, dtype, jdt in (("auto", torch.bfloat16, jnp.bfloat16),
                             ("on", None, jnp.float32), ("off", torch.bfloat16, None)):
        ffn = FFN(m, 4 * m, dtype=dtype, fused=mode, device="cpu")
        xx = x if dtype is not None else x.float()
        want = jdt is not None and supported(128, m, 4 * m, jdt) > 0
        assert ffn._use_fused(xx) == want, (mode, m)
    assert FFN(m, 4 * m, dtype=None, device="cpu")._use_fused(x.float()) is False
    assert (m % 128 == 0) == FFN(m, 4 * m, dtype=torch.bfloat16, device="cpu")._use_fused(x)


@pytest.mark.parametrize("d", [16, 24, 32, 40, 12, 136])
def test_flash_kernel_takes_head_dims_24_and_32(d):
    """The kernel wrapper's shape rule, which runs before any launch: head
    dims 24 (the 3D flagship's), 32 and every other multiple of 8 pass,
    136 included (the route with D at run time); others (12) raise."""
    from gaot_torch.ops.cuda import flash_attention as fa

    qkv = torch.zeros(2, 16, 3, 4, d, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if d % 8 == 0:
        fa._check_kernel_inputs(q, k, v)
    else:
        with pytest.raises(ValueError, match="head dim"):
            fa._check_kernel_inputs(q, k, v)
