"""The port's gather-apply gradients against ``jax.vjp`` of the JAX package's
custom VJPs, on the CPU, at the tiny parity workload's graphs: the dense
decoder route with its transpose graph, the bucketed encoder route with the
in-degree-grouped transpose graph, and unpermute_rows. And the autograd
graph of the tiny model's loss holds no scatter.

Tolerance fp32 rtol 1e-5 / atol 1e-5: the same fp32 products and sums,
taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

RTOL = ATOL = 1e-5
C = 8


@pytest.fixture(scope="module")
def graphs():
    coords, lat, _, _ = tp.workload()
    jcfg, tcfg = tp.configs()
    return tp.jax_graphs(coords, lat, jcfg), tp.torch_graphs(coords, lat, tcfg)


def _leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_gather_multiply_reduce_nbc_matches_vjp(graphs):
    from gaot_torch.ops.gather_apply import gather_multiply_reduce_nbc
    from gaot_tpu.ops.gather_apply import gather_multiply_reduce_nbc as jgmr

    (_, jdec, _, jdec_t), (_, tdec, _, tdec_t) = graphs
    jg, jt, tg, tt = jdec[0], jdec_t[0], tdec[0], tdec_t[0]
    q, k = tg.indices.shape
    n = tt.mask.shape[0]
    rng = np.random.default_rng(11)
    coef = rng.normal(size=(q, k, C)).astype(np.float32)
    f = rng.normal(size=(n, tp.BATCH, C)).astype(np.float32)
    ct = rng.normal(size=(q, tp.BATCH, C)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jgmr(a, b, jg.indices, jt.edge_pos, jt.query,
                                         jt.mask), jnp.asarray(coef), jnp.asarray(f))
    d_coef, d_f = vjp(jnp.asarray(ct))
    cl, fl = _leaf(coef), _leaf(f)
    got = gather_multiply_reduce_nbc(cl, fl, tg.indices, tt.edge_pos, tt.query,
                                     tt.mask)
    _close(got, out)
    got.backward(torch.from_numpy(ct))
    _close(cl.grad, d_coef)
    _close(fl.grad, d_f)


def test_gather_multiply_reduce_nbc_padded_transpose_matches_vjp():
    """A heavily padded flat transpose graph, as the flagship's encoder has
    ([32768, 160] at a mean in-degree of 64): one hub source takes 24 edges,
    so Kt = 24 is three times the mean in-degree and most d_f slots are
    masked padding; the forward graph has left-packed padded slots too."""
    from gaot_torch.ops.gather_apply import gather_multiply_reduce_nbc
    from gaot_torch.ops.padding import PaddedGraph, transpose_graph
    from gaot_tpu.ops.gather_apply import gather_multiply_reduce_nbc as jgmr

    rng = np.random.default_rng(16)
    n, q, k = 48, 96, 4
    idx = rng.integers(1, n, size=(q, k)).astype(np.int32)
    idx[:24, 0] = 0                                  # the hub
    mask = np.arange(k)[None] < rng.integers(2, k + 1, size=(q, 1))
    idx = np.where(mask, idx, 0)
    tg = transpose_graph(PaddedGraph(idx, mask), n)
    mean_deg = float(tg.mask.sum(1).mean())
    assert tg.kt == 24 and tg.kt >= 2.5 * mean_deg, (tg.kt, mean_deg)
    coef = (rng.normal(size=(q, k, C)) * mask[..., None]).astype(np.float32)
    f = rng.normal(size=(n, tp.BATCH, C)).astype(np.float32)
    ct = rng.normal(size=(q, tp.BATCH, C)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jgmr(a, b, idx, tg.edge_pos, tg.query, tg.mask),
                       jnp.asarray(coef), jnp.asarray(f))
    d_coef, d_f = vjp(jnp.asarray(ct))
    cl, fl = _leaf(coef), _leaf(f)
    lt = lambda a: torch.from_numpy(a.astype(np.int64) if a.dtype != np.bool_ else a)
    got = gather_multiply_reduce_nbc(cl, fl, lt(idx), lt(tg.edge_pos), lt(tg.query),
                                     lt(tg.mask))
    _close(got, out)
    got.backward(torch.from_numpy(ct))
    _close(cl.grad, d_coef)
    _close(fl.grad, d_f)


def test_gather_multiply_reduce_matches_vjp(graphs):
    """The batched branch of gather_multiply_reduce (f [B, N, C]) with a
    per-sample coef [B, Q, K, C] (the nonlinear transforms) and the
    transpose-graph backward."""
    from gaot_torch.ops.gather_apply import gather_multiply_reduce
    from gaot_tpu.ops.gather_apply import gather_multiply_reduce as jgmr

    (_, jdec, _, jdec_t), (_, tdec, _, tdec_t) = graphs
    jg, jt, tg, tt = jdec[0], jdec_t[0], tdec[0], tdec_t[0]
    q, k = tg.indices.shape
    n = tt.mask.shape[0]
    rng = np.random.default_rng(15)
    coef = rng.normal(size=(tp.BATCH, q, k, C)).astype(np.float32)
    f = rng.normal(size=(tp.BATCH, n, C)).astype(np.float32)
    ct = rng.normal(size=(tp.BATCH, q, C)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jgmr(a, b, jg.indices, jt.edge_pos, jt.query,
                                         jt.mask), jnp.asarray(coef), jnp.asarray(f))
    d_coef, d_f = vjp(jnp.asarray(ct))
    cl, fl = _leaf(coef), _leaf(f)
    got = gather_multiply_reduce(cl, fl, tg.indices, tt.edge_pos, tt.query, tt.mask)
    _close(got, out)
    got.backward(torch.from_numpy(ct))
    _close(cl.grad, d_coef)
    _close(fl.grad, d_f)


def test_bucketed_gather_multiply_reduce_matches_vjp(graphs):
    """Grouped fx transpose graph: d_coef of every bucket and d_f."""
    from gaot_torch.ops.gather_apply import bucketed_gather_multiply_reduce
    from gaot_torch.ops.padding import GroupedTransposeGraph
    from gaot_tpu.ops.gather_apply import bucketed_gather_multiply_reduce as jbg

    (jenc, _, _, _), (tenc, _, _, _) = graphs
    jb, tb = jenc[0], tenc[0]
    assert isinstance(tb.tgraph, GroupedTransposeGraph) and len(tb.buckets) > 1
    n = tp.NUM_NODES
    rng = np.random.default_rng(12)
    coefs = [rng.normal(size=(*g.indices.shape, C)).astype(np.float32)
             for g in tb.buckets]
    f = rng.normal(size=(n, tp.BATCH, C)).astype(np.float32)
    rows = sum(g.indices.shape[0] for g in tb.buckets)
    ct = rng.normal(size=(rows, tp.BATCH, C)).astype(np.float32)
    jidx = tuple(g.indices for g in jb.buckets)
    out, vjp = jax.vjp(lambda cs, b: jbg(cs, b, jidx, jb.tgraph, 1),
                       tuple(jnp.asarray(a) for a in coefs), jnp.asarray(f))
    d_coefs, d_f = vjp(jnp.asarray(ct))
    cls, fl = [_leaf(a) for a in coefs], _leaf(f)
    got = bucketed_gather_multiply_reduce(cls, fl, [g.indices for g in tb.buckets],
                                          tb.tgraph)
    _close(got, out)
    got.backward(torch.from_numpy(ct))
    for cl, want in zip(cls, d_coefs):
        _close(cl.grad, want)
    _close(fl.grad, d_f)


def test_bucketed_gradient_of_f_needs_the_transpose_graph(graphs):
    """Without a transpose graph the forward runs, d_coef alone is fine, and
    asking for d_f is refused up front."""
    from gaot_torch.ops.gather_apply import bucketed_gather_multiply_reduce

    (_, _, _, _), (tenc, _, _, _) = graphs
    tb = tenc[0]
    idx = [g.indices for g in tb.buckets]
    rng = np.random.default_rng(14)
    coefs = [_leaf(rng.normal(size=(*i.shape, C)).astype(np.float32)) for i in idx]
    f = rng.normal(size=(tp.NUM_NODES, tp.BATCH, C)).astype(np.float32)
    want = bucketed_gather_multiply_reduce(coefs, torch.from_numpy(f), idx,
                                           tb.tgraph)
    got = bucketed_gather_multiply_reduce(coefs, torch.from_numpy(f), idx, None)
    _close(got, want.detach().numpy())
    got.sum().backward()
    assert all(c.grad is not None for c in coefs)
    with pytest.raises(NotImplementedError, match="use_transpose_backward"):
        bucketed_gather_multiply_reduce(coefs, _leaf(f), idx, None)


def test_unpermute_rows_matches_vjp(graphs):
    from gaot_torch.ops.gather_apply import unpermute_rows
    from gaot_tpu.ops.gather_apply import unpermute_rows as junpermute

    (jenc, _, _, _), (tenc, _, _, _) = graphs
    jb, tb = jenc[0], tenc[0]
    rows, q = tb.perm.shape[0], tb.inv_perm.shape[0]
    assert not bool(tb.row_valid.all())          # tile-padding rows exist
    rng = np.random.default_rng(13)
    x = rng.normal(size=(tp.BATCH, rows, C)).astype(np.float32)
    ct = rng.normal(size=(tp.BATCH, q, C)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: junpermute(a, jb.inv_perm, jb.perm, jb.row_valid),
                       jnp.asarray(x))
    (d_x,) = vjp(jnp.asarray(ct))
    xl = _leaf(x)
    got = unpermute_rows(xl, tb.inv_perm, tb.perm, tb.row_valid)
    _close(got, out)
    got.backward(torch.from_numpy(ct))
    _close(xl.grad, d_x)


# Autograd nodes whose backward scatters into (or index-adds onto) the
# gathered tensor. SelectBackward0 is legitimate and appears: the conv1d
# weights [out, in, 1] of the channel MLPs are read as weight[..., 0], a
# basic index of a parameter whose backward writes one dense slice.
_SCATTERS = {"IndexSelectBackward0", "IndexBackward0", "ScatterAddBackward0",
             "IndexAddBackward0", "ScatterBackward0", "GatherBackward0",
             "IndexPutBackward0"}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_no_scatter_on_the_training_path(graphs, dtype):
    from gaot_torch.train.static_trainer import masked_mse

    coords, lat, pndata, target = tp.workload()
    _, tg = graphs
    model = tp.torch_model(dtype).train()
    pred = model(torch.from_numpy(lat), torch.from_numpy(coords),
                 torch.from_numpy(pndata), tg[0], tg[1], encoder_tgraphs=tg[2],
                 decoder_tgraphs=tg[3])
    loss = masked_mse(pred, torch.from_numpy(target), torch.ones(tp.BATCH, dtype=torch.bool))
    seen, stack, names = set(), [loss.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    assert not names & _SCATTERS, names & _SCATTERS
    # The dense and the bucketed apply both run the one flat Function.
    custom = {"_FlatGatherMultiplyReduceBackward", "_PermuteRowsBackward",
              "_FlashAttentionBackward"}
    if dtype == torch.bfloat16:
        custom.add("_FusedFFNBackward")
    assert custom <= names
