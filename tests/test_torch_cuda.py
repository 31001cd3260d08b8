"""gaot_torch's CUDA kernels against their plain versions on the card, at the
shapes the main path does not reach: GQA, ragged sequence and row counts,
channel counts without 16-byte vectors, coef staged in several k-chunks,
the index-reading reduces at every path's lanes with masked slots, K = 0,
int32 indices and an output row map (and two calls bitwise identical),
the narrow lanes of the 3D paths (b = 1 and 4 at C = 16, C = 8) with query
counts that do not fill a block, fp32 attention, every head dim from 8 to
128 and two above (136, 256) at ragged lengths and GQA, head dim 24 at the
3D sequence lengths, the SwiGLU widths 128 to 1024 in bf16 and fp32, K = 1
and an all-masked row of a transpose graph; the gradients of every kernel;
the SwiGLU width the JAX gate sends to the plain route; the models' auto
routes at widths above the templated kernels; what the wrappers refuse; and
the small fx forward and training step against the CPU plain route; the
flash backward at the edges of its bf16 and fp32 tiles, and two of its
calls bitwise identical in each dtype; the fx StaticTrainer's fit on the card against the CPU, with the
splits on the card and on the host; the sequential loader's device route
against its host route, and the fx (with and without the conditional
norm) and vx SequentialTrainers' fits and rollouts against the CPU; the
vx step with each nonlinear transform, node_embedding and without
transpose graphs against the CPU, and the reduce's d_f by the scatter
against its d_f over the transpose graph.

Needs an NVIDIA card and nvcc; skips elsewhere. On the machine with the card
(which has no JAX, so without the JAX-loading conftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# bf16 outputs of fp32 sums: one bf16 ulp; fp32: summation order only.
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-5)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def _close_scaled(got, want, rel, dtype):
    """Every entry within ``rel`` of the tensor's largest magnitude, plus the
    dtype's atol: for gradients, whose small entries are sums that cancel
    (at S = 1 dQ is zero up to rounding)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    bound = rel * float(want.abs().max()) + TOL[dtype][1]
    assert float((got - want).abs().max()) <= bound


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,q,c,b", [(3, 37, 12, 5),      # no 16-byte vectors
                                     (30, 200, 2048, 2),  # coef in k-chunks
                                     (0, 16, 8, 2),       # empty neighbourhood
                                     (7, 130, 64, 3)])
def test_multiply_reduce_k(dtype, k, q, c, b):
    from gaot_torch.ops.cuda import multiply_reduce as mr

    gen = torch.Generator(device="cuda").manual_seed(k + q)
    coef = _rnd(gen, q, k, c).to(dtype).transpose(0, 1)
    gath = _rnd(gen, k, q, b * c).to(dtype)
    n0 = mr.launches["multiply_reduce_k"]
    got = mr.multiply_reduce_k(coef, gath, b)
    torch.cuda.synchronize()
    assert mr.launches["multiply_reduce_k"] == n0 + 1
    _close(got, mr.multiply_reduce_k_plain(coef, gath, b), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,q,c,b", [(3, 37, 12, 5),      # no 16-byte vectors
                                     (1, 16, 64, 64),     # K = 1
                                     (6, 50, 2048, 3),    # wide channels
                                     (5, 96, 64, 64),     # the main path's C, b
                                     (5, 1000, 16, 1),    # the long path's lanes
                                     (5, 333, 16, 4),     # the flagship's lanes
                                     (5, 77, 8, 4),       # C = 8, a partial block
                                     (3, 129, 8, 1)])
def test_multiply_reduce_b(dtype, k, q, c, b):
    from gaot_torch.ops.cuda import multiply_reduce as mr

    gen = torch.Generator(device="cuda").manual_seed(k * q)
    gath = _rnd(gen, k, q, b * c).to(dtype)
    dout = _rnd(gen, q, b * c).to(dtype)
    n0 = mr.launches["multiply_reduce_b"]
    got = mr.multiply_reduce_b(gath, dout, b)
    torch.cuda.synchronize()
    assert mr.launches["multiply_reduce_b"] == n0 + 1
    _close(got, mr.multiply_reduce_b_plain(gath, dout, b), dtype)


# (K, Q, b, C, index dtype, form) of the index-reading reduce: the paths'
# lane widths W = 16 (long), 64 (flagship) and 4096 (fx), the flagship's
# transpose fan-in K = 160 with most slots masked (its slots split into 4
# slices at W = 64 and 16 at W = 16, the last block of rows partial), no
# 16-byte vectors (C = 6), K = 0, int32 indices. "fwd": coefficients per edge, every slot;
# "strided": the same with coefficients in a K-major view; "df": a table
# read by a second index, left-packed masks with all-masked rows, and an
# output row map into a larger output.
_GATHER_K = [(8, 1000, 1, 16, torch.int64, "fwd"), (8, 333, 4, 16, torch.int32, "df"),
             (24, 60, 64, 64, torch.int64, "df"), (160, 70, 4, 16, torch.int64, "df"),
             (160, 50, 1, 16, torch.int32, "df"), (40, 33, 2, 8, torch.int64, "fwd"),
             (5, 37, 5, 6, torch.int32, "fwd"), (7, 41, 5, 6, torch.int64, "df"),
             (0, 16, 2, 8, torch.int64, "df"), (9, 130, 3, 64, torch.int64, "strided")]


def _gather_k_inputs(gen, dtype, k, q, b, c, itype, form, n=300):
    """src, idx, coef and the keyword arguments of one gathering call."""
    src = _rnd(gen, n, b * c).to(dtype)
    idx = torch.randint(0, n, (q, k), generator=gen, device="cuda").to(itype)
    kw = {}
    if form == "df":
        deg = torch.randint(0, k + 1, (q, 1), generator=gen, device="cuda")
        deg[::7] = 0                                    # rows with no valid slot
        kw["mask"] = torch.arange(k, device="cuda")[None] < deg
        idx = torch.where(kw["mask"], idx, -1)          # masked: never read
        coef = _rnd(gen, 5 * max(q * k, 1), c).to(dtype)
        kw["coef_idx"] = torch.randint(0, coef.shape[0], (q, k), generator=gen,
                                       device="cuda").to(itype)
        kw["row_map"] = torch.randperm(q + 9, generator=gen, device="cuda")[:q].to(itype)
        kw["out"] = torch.zeros(q + 9, b * c, dtype=dtype, device="cuda")
    elif form == "strided":
        coef = _rnd(gen, k, q, c).to(dtype).transpose(0, 1)
    else:
        coef = _rnd(gen, q, k, c).to(dtype)
    return src, idx, coef, kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,q,b,c,itype,form", _GATHER_K)
def test_gather_multiply_reduce_k(dtype, k, q, b, c, itype, form):
    from gaot_torch.ops.cuda import multiply_reduce as mr

    gen = torch.Generator(device="cuda").manual_seed(k + q)
    src, idx, coef, kw = _gather_k_inputs(gen, dtype, k, q, b, c, itype, form)
    plain_kw = {key: (v.clone() if key == "out" else v) for key, v in kw.items()}
    n0 = mr.launches["multiply_reduce_k"]
    got = mr.gather_multiply_reduce_k(src, idx, coef, b, **kw)
    torch.cuda.synchronize()
    assert mr.launches["multiply_reduce_k"] == n0 + 1
    want = mr.gather_multiply_reduce_k_plain(src, idx, coef, b, **plain_kw)
    _close(got, want, dtype)
    if form == "df":                                    # rows with no valid slot
        assert not got[kw["row_map"][::7].long()].any()


_GATHER_B = [(8, 1000, 1, 16, torch.int64), (8, 333, 4, 16, torch.int32),
             (5, 96, 64, 64, torch.int64), (3, 37, 5, 6, torch.int32),
             (1, 16, 64, 64, torch.int64), (6, 50, 3, 2048, torch.int64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,q,b,c,itype", _GATHER_B)
def test_gather_multiply_reduce_b(dtype, k, q, b, c, itype):
    """The index-reading d_coef at the paths' lanes (W = 16, 64, 4096), no
    16-byte vectors (C = 6), K = 1, wide channels, int32 indices."""
    from gaot_torch.ops.cuda import multiply_reduce as mr

    gen = torch.Generator(device="cuda").manual_seed(k * q)
    src = _rnd(gen, 200, b * c).to(dtype)
    idx = torch.randint(0, 200, (q, k), generator=gen, device="cuda").to(itype)
    dout = _rnd(gen, q, b * c).to(dtype)
    n0 = mr.launches["multiply_reduce_b"]
    got = mr.gather_multiply_reduce_b(src, idx, dout, b)
    torch.cuda.synchronize()
    assert mr.launches["multiply_reduce_b"] == n0 + 1
    _close(got, mr.gather_multiply_reduce_b_plain(src, idx, dout, b), dtype)


def test_gather_multiply_reduce_is_deterministic():
    """Two calls of each index-reading kernel on the same inputs give the
    same bits (the flagship's lanes and transpose fan-in, bf16)."""
    from gaot_torch.ops.cuda import multiply_reduce as mr

    gen = torch.Generator(device="cuda").manual_seed(3)
    src, idx, coef, kw = _gather_k_inputs(gen, torch.bfloat16, 160, 2000, 4, 16,
                                          torch.int64, "df", n=5000)
    first = mr.gather_multiply_reduce_k(src, idx, coef, 4, **kw).clone()
    assert torch.equal(first, mr.gather_multiply_reduce_k(src, idx, coef, 4, **kw))
    idx = torch.randint(0, 5000, (2000, 8), generator=gen, device="cuda")
    dout = _rnd(gen, 2000, 64).bfloat16()
    assert torch.equal(mr.gather_multiply_reduce_b(src, idx, dout, 4),
                       mr.gather_multiply_reduce_b(src, idx, dout, 4))


# GQA and ragged S at every templated head dim (8 to 128; the 3D flagship's
# 24 and the fx path's 32 first) and five of the routes with D at run time
# (136, 256; 264 with a ragged last output slice of 8 columns, 512 and 1024
# with several slices, the bf16 forward's queries resident at 512 and
# streamed at 1024); head dim 24 also at S = 4096 (the regime of the TPU's
# q-tiled backward) and 8192 (its two-kernel long backward). At D % 16 == 8
# the bf16 products over D take a last k-step of 16 whose upper half is zero.
_FLASH_DIMS = ([24, 32] + [d for d in range(8, 129, 8) if d not in (24, 32)]
               + [136, 256, 264, 512, 1024])
_FLASH_SHAPES = [(b, s, h, hkv, d) for d in _FLASH_DIMS
                 for b, s, h, hkv in ((2, 100, 8, 2), (1, 1, 4, 4), (3, 257, 6, 3))]
_FLASH_3D = [(2, 4096, 8, 8, 24), (1, 8192, 4, 2, 24)]


def _qkv(gen, dtype, b, s, h, hkv, d):
    """Strided views of one packed projection, as the attention block makes."""
    qkv = _rnd(gen, b, s, h + 2 * hkv, d).to(dtype)
    return qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hkv,d", _FLASH_SHAPES + _FLASH_3D)
def test_flash_attention(dtype, b, s, h, hkv, d):
    from gaot_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(s + h + d)
    q, k, v = _qkv(gen, dtype, b, s, h, hkv, d)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    _close(got, fa.attention_plain(q, k, v), dtype)


# The backward at the head dims besides 24 and 32 skips S = 1: there dQ and
# dK are zero (the kernel gives exact zeros) and the plain version's bf16
# rounding alone reaches 1.4e-2 at D = 104, above the bound's atol.
_FLASH_BWD_SHAPES = [x for x in _FLASH_SHAPES if x[4] in (24, 32) or x[1] > 1]
# The edges of the backward's tiles: in bf16 blocks of 128 resident rows,
# streamed sub-tiles of 64 rows (32 queries in dK/dV at D > 64) in stages of
# up to 256; in fp32 (csrc/flash_f32.cuh) blocks of 128 or 64 rows, streamed
# tiles of 16, 32 or 64; so S one below, at and one above each; the smallest
# head dim, the largest templated one and one of each line of the fp32
# tile table, GQA 4:1; and the routes above 128 (blocks of 128 rows, tiles
# of 64; in fp32 chunks of 32 and pieces of 64 columns) at one slice (136)
# and a ragged second one (264).
_FLASH_BWD_EDGES = [(1, s, 4, 1, d) for d in (8, 24, 32, 48, 64, 72, 128, 136, 264)
                    for s in (15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256,
                              257)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hkv,d", _FLASH_BWD_SHAPES + [(1, 128, 4, 1, 32)] + _FLASH_3D
                         + _FLASH_BWD_EDGES)
def test_flash_attention_backward(dtype, b, s, h, hkv, d):
    """The LSE output and dQ, dK, dV (through autograd) against the plain
    versions. GQA and ragged S. bf16: the kernel normalises p from the LSE
    where the plain version follows the TPU kernel's folded scales, so bf16
    rounds at other places: 3% of each gradient's largest entry."""
    from gaot_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7 * s + h + d)
    q, k, v = _qkv(gen, dtype, b, s, h, hkv, d)
    out, lse = fa.flash_attention_lse(q, k, v)
    want_out, want_lse = fa.attention_plain(q, k, v, with_lse=True)
    _close(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)

    dout = _rnd(gen, b, s, h, d).to(dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    n0 = dict(fa.launches)
    fa.flash_attention(*leaves).backward(dout)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_fwd_lse"] == n0["flash_attention_fwd_lse"] + 1
    assert fa.launches["flash_attention_bwd"] == n0["flash_attention_bwd"] + 1
    want = fa.attention_bwd_plain(q, k, v, want_out, dout)
    rel = 3e-2 if dtype == torch.bfloat16 else 1e-4
    for leaf, w in zip(leaves, want):
        _close_scaled(leaf.grad, w, rel, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hkv,d", [(64, 1024, 8, 8, 32), (2, 1000, 8, 2, 24),
                                         (2, 257, 6, 3, 264)])
def test_flash_attention_backward_is_deterministic(dtype, b, s, h, hkv, d):
    """No float atomics: two calls on the same inputs give the same bits, at
    the fx path's shape, at a GQA shape and at a GQA shape of the route above
    head dim 128."""
    from gaot_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v = _qkv(gen, dtype, b, s, h, hkv, d)
    out, lse = fa.flash_attention_lse(q, k, v)
    dout = _rnd(gen, b, s, h, d).to(dtype)
    first = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    second = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_ffn_width_192_runs_plain_on_the_card():
    """The flagship's SwiGLU width M = 192 fails the JAX package's gate, so
    a bf16 CUDA tensor takes the plain three products: no kernel launch, no
    error, the plain route recorded."""
    from gaot_torch.models.transformer import FFN
    from gaot_torch.ops.cuda import fused_ffn as ff
    from gaot_torch.utils.routing import format_routes, reset_routes

    gen = torch.Generator(device="cuda").manual_seed(5)
    ffn = FFN(192, 768, dtype=torch.bfloat16, fused="auto", device="cuda")
    x = _rnd(gen, 2, 64, 192).bfloat16().requires_grad_(True)
    n0 = dict(ff.launches)
    reset_routes()
    out = ffn(x)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert ff.launches == n0
    assert "ffn=plain" in format_routes()
    assert out.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()


# (R, M, F): ragged R at every tuned width (128-512) and at widths of the
# general route (640-1024); F the multiples of 128 the JAX gate takes.
_FFN_SHAPES = [(200, 256, 128), (64, 256, 1024), (1, 256, 128), (200, 128, 256),
               (130, 384, 128), (200, 512, 128), (64, 512, 1024), (200, 640, 256),
               (70, 768, 128), (130, 896, 256), (100, 1024, 384)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,m,f", _FFN_SHAPES)
def test_fused_ffn(dtype, r, m, f):
    from gaot_torch.ops.cuda import fused_ffn as ff

    gen = torch.Generator(device="cuda").manual_seed(r + f)
    x = _rnd(gen, r, m).to(dtype)
    w1 = (_rnd(gen, f, m) / m ** 0.5).to(dtype)
    w3 = (_rnd(gen, f, m) / m ** 0.5).to(dtype)
    w2 = (_rnd(gen, m, f) / f ** 0.5).to(dtype)
    n0 = ff.launches["fused_ffn_fwd"]
    got = ff.fused_ffn(x, w1, w3, w2)
    torch.cuda.synchronize()
    assert ff.launches["fused_ffn_fwd"] == n0 + 1
    _close(got, ff.fused_ffn_plain(x, w1, w3, w2), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,f,m", [(200, 128, 256), (1, 128, 256), (4096, 1024, 256),
                                   (70, 256, 256), (200, 128, 128), (1, 128, 128),
                                   (4096, 1024, 128),
                                   (70, 128, 384), (1000, 256, 384), (200, 128, 512),
                                   (1, 128, 512), (1000, 256, 512), (300, 256, 640),
                                   (130, 128, 1024)])
def test_fused_ffn_backward(dtype, r, f, m):
    """dx and dW1, dW3, dW2 (through autograd) against the plain backward,
    ragged R included, at tuned and general widths. bf16: both round dh1 and
    dh3 to bf16 from fp32 sums taken in other orders, 2% of each gradient's
    largest entry; fp32: sums over the rows in other orders, 1e-4."""
    from gaot_torch.ops.cuda import fused_ffn as ff

    gen = torch.Generator(device="cuda").manual_seed(3 * r + f)
    x = _rnd(gen, r, m).to(dtype)
    ws = [(_rnd(gen, f, m) / m ** 0.5).to(dtype),
          (_rnd(gen, f, m) / m ** 0.5).to(dtype),
          (_rnd(gen, m, f) / f ** 0.5).to(dtype)]
    dout = _rnd(gen, r, m).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in [x] + ws]
    n0 = ff.launches["fused_ffn_bwd"]
    ff.fused_ffn(*leaves).backward(dout)
    torch.cuda.synchronize()
    assert ff.launches["fused_ffn_bwd"] == n0 + 1
    want = ff.fused_ffn_bwd_plain(x, *ws, dout)
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for leaf, w in zip(leaves, want):
        _close_scaled(leaf.grad, w.to(leaf.dtype), rel, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_apply_grads_card_vs_cpu(dtype):
    """The dense transpose-graph route with K = 1 and a source node no edge
    reaches (an all-masked transpose row, whose d_f must be 0), the
    bucketed route with a grouped transpose graph, and unpermute_rows: d_f
    and d_coef on the card against the CPU plain route."""
    from gaot_torch.ops import gather_apply as ga
    from gaot_torch.ops.padding import (PaddedGraph, TransposeGraph,
                                        bucketize_graph, degree_group_tgraph,
                                        graph_to_device, transpose_graph)

    rng = np.random.default_rng(0)
    n, q, b, c = 40, 300, 3, 16
    idx = rng.integers(1, n, size=(q, 1)).astype(np.int32)   # node 0 unreached
    dense = PaddedGraph(idx, np.ones((q, 1), bool))
    tg = transpose_graph(dense, n)
    assert not tg.mask[0].any()
    deg = rng.integers(1, 20, size=q)
    big = rng.integers(0, n, size=(q, 24)).astype(np.int32)
    msk = np.arange(24)[None] < deg[:, None]
    bg = bucketize_graph(PaddedGraph(np.where(msk, big, 0), msk), n,
                         tile=8, launch_penalty_rows=0, min_k=1, min_gain=0.0)
    assert bg is not None and len(bg.buckets) > 1
    t = bg.tgraph
    bg = bg._replace(tgraph=degree_group_tgraph(
        TransposeGraph(t.edge_pos[None], t.query[None], t.mask[None])))
    f = rng.normal(size=(n, b, c)).astype(np.float32)
    coef = rng.normal(size=(q, 1, c)).astype(np.float32)
    coefs = [rng.normal(size=(*g.indices.shape, c)).astype(np.float32)
             for g in bg.buckets]
    rows = sum(g.indices.shape[0] for g in bg.buckets)
    dout = rng.normal(size=(q, b, c)).astype(np.float32)
    dcat = rng.normal(size=(rows, b, c)).astype(np.float32)
    xcat = rng.normal(size=(b, rows, c)).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaf = lambda a: torch.from_numpy(a).to(dev, dtype).requires_grad_(True)
        dg, dt, dbg = (graph_to_device(x, dev) for x in (dense, tg, bg))
        fl, fb, cl, xl = leaf(f), leaf(f), leaf(coef), leaf(xcat)
        cls = [leaf(a) for a in coefs]
        out = ga.gather_multiply_reduce_nbc(cl, fl, dg.indices, dt.edge_pos,
                                            dt.query, dt.mask)
        out.backward(torch.from_numpy(dout).to(dev, dtype))
        cat = ga.bucketed_gather_multiply_reduce(
            cls, fb, [g.indices for g in dbg.buckets], dbg.tgraph)
        cat.backward(torch.from_numpy(dcat).to(dev, dtype))
        un = ga.unpermute_rows(xl, dbg.inv_perm, dbg.perm, dbg.row_valid)
        un.square().sum().backward()
        grads[dev] = [g.grad.float().cpu() for g in [fl, fb, cl, xl] + cls]
    assert not grads["cuda"][0][0].any()        # the node no edge reaches
    rtol, atol = TOL[dtype]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol * 10)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """What the kernels do not take raises: a head dim that is not a
    multiple of 8, the backward without the forward's LSE, mixed dtypes, an
    FFN width F the JAX gate refuses (F % 128) and mismatched shapes."""
    from gaot_torch.ops.cuda import flash_attention as fa
    from gaot_torch.ops.cuda import fused_ffn as ff
    from gaot_torch.ops.cuda import multiply_reduce as mr

    q = torch.zeros(1, 8, 2, 36, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)                     # head dim 36
    q = torch.zeros(1, 8, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="LSE"):
        fa.flash_attention_bwd(q, q, q, q, q)           # no forward LSE
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q)          # mixed dtypes
    x = torch.zeros(4, 256, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(96, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="JAX gate"):
        ff.fused_ffn(x, w, w, w.t().contiguous())       # F = 96
    w = torch.zeros(128, 256, device="cuda")
    with pytest.raises(TypeError):
        ff.fused_ffn(x, w, w, w.t().contiguous())       # bf16 x, fp32 weights
    with pytest.raises(ValueError, match="shape"):
        ff.fused_ffn(x, w.bfloat16(), w.bfloat16(), w.bfloat16())   # w2 not [M, F]
    g = torch.zeros(2, 4, 8, device="cuda")
    with pytest.raises(TypeError):
        mr.multiply_reduce_b(g, g[0].bfloat16(), 2)     # mixed dtypes


def test_auto_routes_raise_on_widths_the_kernels_do_not_take():
    """The models' routes reach the kernels at every width the JAX gates
    take, and nothing raises there: attention at head dim 136 (the route
    with D at run time), the SwiGLU at M = 640 in bf16 under "auto" (the
    general route) and in fp32 under "on" (the fp32 kernels), each forward
    and backward launching its kernels and matching the plain version."""
    from gaot_torch.models.transformer import FFN, GroupQueryAttention
    from gaot_torch.ops.cuda import flash_attention as fa
    from gaot_torch.ops.cuda import fused_ffn as ff

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = GroupQueryAttention(1088, 1088, num_heads=8, num_kv_heads=8,
                               backend="auto", device="cuda")
    x = _rnd(gen, 2, 16, 1088)
    n0 = dict(fa.launches)
    with torch.no_grad():
        got = attn(x)                                   # head dim 136
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_fwd"] == n0["flash_attention_fwd"] + 1
    assert got.shape == x.shape and torch.isfinite(got).all()
    cases = [(640, 512, torch.bfloat16, "auto"), (256, 512, torch.float32, "on")]
    for m, f, dtype, mode in cases:
        ffn = FFN(m, f, dtype=dtype, fused=mode, device="cuda")
        x = _rnd(gen, 2, 16, m).to(dtype).requires_grad_(True)
        n0 = dict(ff.launches)
        out = ffn(x)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert ff.launches["fused_ffn_fwd"] == n0["fused_ffn_fwd"] + 1, (m, dtype)
        assert ff.launches["fused_ffn_bwd"] == n0["fused_ffn_bwd"] + 1, (m, dtype)
        ws = [lin.weight.to(dtype) for lin in (ffn.w1, ffn.w3, ffn.w2)]
        xd = x.detach().reshape(-1, m)
        _close(out.detach().reshape(-1, m), ff.fused_ffn_plain(xd, *ws), dtype)
        assert torch.isfinite(x.grad.float()).all()


def _small_setup():
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.data.graph_builder import GraphBuilder

    cfg = merge_config(ModelConfig, {
        "latent_tokens_size": [32, 32],
        "args": {"magno": {"radius": 0.067, "hidden_size": 16,
                           "lifting_channels": 8},
                 "transformer": {"patch_size": 2, "hidden_size": 256,
                                 "attn_config": {"num_heads": 8,
                                                 "num_kv_heads": 4}}}})
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (2000, 2)).astype(np.float32)
    ax = np.linspace(-1, 1, 32)
    lat = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
    lat = lat.astype(np.float32)
    pndata = rng.normal(size=(2, 2000, 1)).astype(np.float32)
    target = rng.normal(size=(2, 2000, 1)).astype(np.float32)
    enc, dec = GraphBuilder().build_fx_graphs(coords, lat, 0.067, [1.0])
    return cfg, coords, lat, pndata, target, enc, dec


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_small_forward_card_vs_cpu(dtype):
    """A small fx GAOT (hidden 256, GQA with head dim 32, SwiGLU width 1024): every kernel launches
    and the card agrees with the CPU plain route (fp32: rtol 1e-3; bf16:
    relative L2 2e-2, bf16 rounds at other places on the CPU)."""
    from gaot_torch.data.graph_builder import prepare_fx_device_graphs
    from gaot_torch.models import GAOT
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.static_trainer import FxGraphs, eval_step

    cfg, coords, lat, pndata, _, enc, dec = _small_setup()
    preds = {}
    kernels.reset_launches()
    for dev in ("cuda", "cpu"):
        g = prepare_fx_device_graphs(enc, dec, 2000, lat.shape[0],
                                     cfg.args.magno, device=dev)
        model = GAOT(1, 1, cfg, dtype=dtype, device=dev,
                     generator=torch.Generator().manual_seed(3))
        t = lambda a: torch.from_numpy(a).to(dev)
        pred, _ = eval_step(model.eval(), FxGraphs(t(lat), *g), t(coords),
                            t(pndata), t(pndata), torch.ones(2, dtype=torch.bool,
                                                             device=dev))
        preds[dev] = pred.float().cpu()
    counts = kernels.launch_counts()
    assert counts["multiply_reduce_k"] >= 2 and counts["flash_attention_fwd"] == 3
    assert counts["fused_ffn_fwd"] == (3 if dtype == torch.bfloat16 else 0)
    got, want = preds["cuda"], preds["cpu"]
    if dtype is None:
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-3 * float(want.abs().max()))
    else:
        assert float((got - want).norm() / want.norm()) <= 2e-2


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_small_train_step_card_vs_cpu(dtype):
    """Two AdamW steps of the small fx GAOT: every backward kernel launches
    in each, and the card's losses and updated weights agree with the CPU
    plain route (fp32: 1e-3 relative; bf16: relative L2 5e-2 over all
    weights, bf16 rounds at other places on the CPU)."""
    from gaot_torch.core.config import OptimizerConfig, merge_config
    from gaot_torch.data.graph_builder import prepare_fx_device_graphs
    from gaot_torch.models import GAOT
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import FxGraphs, train_step

    cfg, coords, lat, pndata, target, enc, dec = _small_setup()
    ocfg = merge_config(OptimizerConfig, {"args": {"epoch": 10}})
    losses, weights = {}, {}
    for dev in ("cuda", "cpu"):
        g = prepare_fx_device_graphs(enc, dec, 2000, lat.shape[0],
                                     cfg.args.magno, device=dev)
        model = GAOT(1, 1, cfg, dtype=dtype, device=dev,
                     generator=torch.Generator().manual_seed(3))
        opt, sched = make_optimizer(ocfg, model.parameters(), steps_per_epoch=1)
        t = lambda a: torch.from_numpy(a).to(dev)
        kernels.reset_launches()
        losses[dev] = [float(train_step(
            model, opt, sched, step, FxGraphs(t(lat), *g), t(coords), t(pndata),
            t(target), torch.ones(2, dtype=torch.bool, device=dev)))
            for step in range(2)]
        counts = kernels.launch_counts()
        if dev == "cuda":
            assert counts["multiply_reduce_b"] >= 4 and counts["flash_attention_bwd"] == 6
            assert counts["fused_ffn_bwd"] == (6 if dtype == torch.bfloat16 else 0)
        else:
            assert not any(counts.values())
        weights[dev] = torch.cat([p.detach().float().cpu().reshape(-1)
                                  for p in model.parameters()])
    assert all(np.isfinite(losses["cuda"]))
    got, want = weights["cuda"], weights["cpu"]
    if dtype is None:
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=5e-2)
        assert float((got - want).norm() / want.norm()) <= 5e-2


@pytest.mark.parametrize("device_data", [True, False])
def test_static_trainer_card_vs_cpu(tmp_path, device_data):
    """The fx StaticTrainer's fit (fp32) on the card against the same fit on
    the CPU: the loss records and the relative error within 1e-3 relative;
    the card's steps launch the kernels. With ``device_data`` the split
    buffers live on the card; without it, batches are copied from pinned
    memory on the prefetch thread."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synthetic import make_static_fx_dataset

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train import StaticTrainer

    make_static_fx_dataset(str(tmp_path / "toy.npz"))
    model = {"latent_tokens_size": [8, 8],
             "args": {"magno": {"radius": 0.25, "hidden_size": 8, "mlp_layers": 1,
                                "lifting_channels": 8},
                      "transformer": {"patch_size": 2, "hidden_size": 16,
                                      "num_layers": 2,
                                      "attn_config": {"num_heads": 2,
                                                      "num_kv_heads": 2}}}}
    records, errors = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        cfg = {"setup": {"seed": 0, "device": dev}, "model": model,
               "dataset": {"name": "toy", "metaname": "elliptic_pdes/Poisson-Gauss",
                           "base_path": str(tmp_path), "train_size": 8,
                           "val_size": 2, "test_size": 2, "batch_size": 4,
                           "device_data": device_data},
               "optimizer": {"args": {"epoch": 4, "eval_every_eps": 2}},
               "path": {"ckpt_path": str(out / "ckpt"), "loss_path": str(out / "loss.png"),
                        "result_path": str(out / "result.png"),
                        "database_path": str(out / "db.csv")}}
        trainer = StaticTrainer(json.loads(json.dumps(cfg)))
        batch = next(iter(trainer.train_loader))
        assert isinstance(batch["u"], torch.Tensor) is device_data
        kernels.reset_launches()
        trainer.fit(verbose=False)
        counts = kernels.launch_counts()
        if dev == "cuda":
            assert counts["multiply_reduce_b"] > 0 and counts["flash_attention_bwd"] == 2 * 8
        else:
            assert not any(counts.values())
        records[dev] = np.load(out / "loss.npz")
        errors[dev] = trainer.datarow["relative error (direct)"]
    for k in ("losses", "val_losses"):
        np.testing.assert_allclose(records["cuda"][k], records["cpu"][k], rtol=1e-3)
    np.testing.assert_allclose(errors["cuda"], errors["cpu"], rtol=1e-3)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_vx_train_step_card_vs_cpu(dtype):
    """One AdamW step of a small vx GAOT (a mesh per sample, bucketed
    encoder and decoder, two scales with scale weights): the vx reduces
    launch, and the card's loss and every gradient agree with the CPU
    plain route (fp32: each gradient within 1e-3 of its largest entry;
    bf16: relative L2 5e-2 over all gradients)."""
    counts = _vx_step_card_vs_cpu(dtype, {})
    assert counts["multiply_reduce_k"] >= 8 and counts["multiply_reduce_b"] >= 4


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("option", ["nonlinear", "nonlinear_kernelonly", "node_embedding",
                                    "no_transpose"])
def test_vx_option_train_step_card_vs_cpu(dtype, option):
    """:func:`test_vx_train_step_card_vs_cpu` with a nonlinear transform
    (dense graphs, the plain per-edge body: no multiply-reduce in the AGNO,
    only the rows' reorder there is none of), node_embedding (the linear
    table) and without transpose graphs (d_f by the scatter: no d_f
    reduce)."""
    magno = {"no_transpose": {"use_transpose_backward": False},
             "node_embedding": {"node_embedding": True}}.get(
        option, {"transform_type": option})
    counts = _vx_step_card_vs_cpu(dtype, magno)
    if option.startswith("nonlinear"):
        assert not any(counts.values())
    else:
        assert counts["multiply_reduce_k"] >= 4 and counts["multiply_reduce_b"] >= 4


def _vx_step_card_vs_cpu(dtype, magno):
    """The step of :func:`test_vx_train_step_card_vs_cpu` with the MAGNO
    options ``magno``, its graphs built as the trainers build them; returns
    the card's multiply-reduce launches."""
    from gaot_torch.core.config import ModelConfig, OptimizerConfig, merge_config
    from gaot_torch.data.graph_builder import (
        GraphBuilder,
        vx_flat_graphs,
        vx_graph_buffers,
        vx_layout,
    )
    from gaot_torch.models import GAOT
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import FxGraphs, train_step

    cfg = merge_config(ModelConfig, {
        "latent_tokens_size": [16, 16],
        "args": {"magno": {"radius": 0.14, "hidden_size": 64, "lifting_channels": 64,
                           "scales": [1.0, 1.5], "use_scale_weights": True, **magno},
                 "transformer": {"patch_size": 2, "hidden_size": 256, "num_layers": 1}}})
    m = cfg.args.magno
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 600, 2)).astype(np.float32)
    ax = np.linspace(-1, 1, 16)
    lat = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    split = GraphBuilder(morton=True).build_all_vx_graphs(
        {"test": {"x": x}}, lat, 0.14, [1.0, 1.5], build_train=False,
        with_transpose=m.use_transpose_backward,
        bucketing=m.transform_type in ("linear", "linear_kernelonly"))["test"]
    bufs = vx_graph_buffers(split)
    bufs.pop("node_perm")
    bufs.update(vx_layout(bufs, 2))
    n_pad = split.coords.shape[1]
    pndata = rng.normal(size=(2, n_pad, 1)).astype(np.float32)
    target = rng.normal(size=(2, n_pad, 1)).astype(np.float32)
    ocfg = merge_config(OptimizerConfig, {"args": {"epoch": 10}})
    res = {}
    for dev in ("cuda", "cpu"):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
        graphs = FxGraphs(torch.from_numpy(lat).to(dev), *vx_flat_graphs(batch, 2))
        model = GAOT(1, 1, cfg, dtype=dtype, device=dev,
                     generator=torch.Generator().manual_seed(3))
        opt, sched = make_optimizer(ocfg, model.parameters(), steps_per_epoch=1)
        grads = {}
        opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}))
        t = lambda a: torch.from_numpy(a).to(dev)
        kernels.reset_launches()
        loss = train_step(model, opt, sched, 0, graphs, batch["x"], t(pndata), t(target),
                          torch.ones(2, dtype=torch.bool, device=dev), batch["node_mask"])
        counts = {k: v for k, v in kernels.launch_counts().items()
                  if k.startswith("multiply_reduce")}
        if dev == "cpu":
            assert not any(kernels.launch_counts().values())
        res[dev] = (float(loss), grads, counts)
    (lc, gc, counts), (lp, gp, _) = res["cuda"], res["cpu"]
    assert set(gc) == set(gp)
    if dtype is None:
        assert abs(lc - lp) <= 1e-4 * abs(lp)
        for n in gp:
            assert float((gc[n] - gp[n]).abs().max()) <= 1e-3 * float(gp[n].abs().max()), n
    else:
        cat = lambda g: torch.cat([g[n].reshape(-1) for n in sorted(g)])
        assert abs(lc - lp) <= 2e-2 * abs(lp)
        assert float((cat(gc) - cat(gp)).norm() / cat(gp).norm()) <= 5e-2
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_df_card_vs_transpose_graph(dtype):
    """d_f of the vx reduce without a transpose graph (the scatter) on the
    card against d_f over the in-degree-grouped transpose graph, on masks
    with holes (their coefficients zero, as the AGNO folds them); the
    forward and d_coef the same bits, and no d_f reduce launched."""
    from gaot_torch.data.graph_builder import (
        GraphBuilder,
        vx_flat_graphs,
        vx_graph_buffers,
        vx_layout,
    )
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.ops.gather_apply import df_calls, flat_gather_multiply_reduce

    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (4, 600, 2)).astype(np.float32)
    ax = np.linspace(-1, 1, 16)
    lat = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    split = GraphBuilder(morton=True).build_all_vx_graphs(
        {"test": {"x": x}}, lat, 0.14, [1.0], build_train=False, with_transpose=True,
        bucketing=True)["test"]
    bufs = vx_graph_buffers(split)
    bufs.pop("node_perm")
    bufs.update(vx_layout(bufs, 4))
    batch = {k: torch.from_numpy(v).cuda() for k, v in bufs.items()}
    c = 64
    enc, dec = vx_flat_graphs(batch, 1)
    for vg, n_src in ((enc[0], split.coords.shape[1]), (dec[0], lat.shape[0])):
        vg = vg._replace(buckets=tuple(
            g._replace(mask=g.mask & (torch.rand(g.mask.shape, device="cuda") > 0.3))
            for g in vg.buckets))
        n = 4 * n_src            # d_f over the transpose graph writes every source row
        coefs = [(torch.randn(*g.indices.shape, c, device="cuda")
                  * g.mask[..., None]).to(dtype) for g in vg.buckets]
        f = torch.randn(n, c, device="cuda", dtype=dtype)
        dout = torch.randn(4 * vg.rows, c, device="cuda", dtype=dtype)
        res = {}
        for name, g in (("scatter", vg._replace(tgraph=None)), ("tgraph", vg)):
            cls = [a.clone().requires_grad_(True) for a in coefs]
            fl = f.clone().requires_grad_(True)
            kernels.reset_launches()
            out = flat_gather_multiply_reduce(cls, fl, g)
            out.backward(dout)
            res[name] = (out.detach(), [a.grad for a in cls], fl.grad,
                         kernels.launch_counts()["multiply_reduce_k"])
        (o_s, dc_s, df_s, k_s), (o_t, dc_t, df_t, k_t) = res["scatter"], res["tgraph"]
        assert torch.equal(o_s, o_t)
        assert all(torch.equal(a, b) for a, b in zip(dc_s, dc_t))
        assert k_t - k_s == len(df_calls(vg, 1))
        _close_scaled(df_s, df_t, 1e-2 if dtype == torch.bfloat16 else 1e-5, dtype)


def _seq_config(tmp_path, dev, name, model=None, **dataset):
    ds = {"name": name, "metaname": "incompressible_fluids/NS-Gauss",
          "base_path": str(tmp_path), "train_size": 6, "val_size": 2, "test_size": 3,
          "batch_size": 16, "max_time_diff": 14, "time_step": 2,
          "stepper_mode": "time_der", "predict_mode": "all"}
    ds.update(dataset)
    out = tmp_path / dev
    return {"setup": {"seed": 0, "device": dev, "trainer_name": "sequential"},
            "model": model or {
                "latent_tokens_size": [8, 8],
                "args": {"magno": {"radius": 0.25, "hidden_size": 8, "mlp_layers": 1,
                                   "lifting_channels": 8},
                         "transformer": {"patch_size": 2, "hidden_size": 16,
                                         "num_layers": 2,
                                         "attn_config": {"num_heads": 2,
                                                         "num_kv_heads": 2}}}},
            "dataset": ds,
            "optimizer": {"args": {"epoch": 2, "eval_every_eps": 2}},
            "path": {"ckpt_path": str(out / "ckpt"), "loss_path": str(out / "loss.png"),
                     "result_path": str(out / "result.png"),
                     "database_path": str(out / "db.csv")}}


@pytest.mark.parametrize("stepper", ["output", "residual", "time_der"])
def test_pair_batches_card_vs_host(tmp_path, stepper):
    """The sequential loader's device route on the card (fp32) against the
    host route (NumPy float64, cast to fp32): inputs and targets within
    1e-6 relative; one index_select of u, none of c (the set has none)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synthetic import make_sequential_fx_dataset

    from gaot_torch.data.sequential import DynamicPairBatcher
    from gaot_torch.train import SequentialTrainer

    make_sequential_fx_dataset(str(tmp_path / "seq.npz"))
    trainer = SequentialTrainer(_seq_config(tmp_path, "cuda", "seq", stepper_mode=stepper))
    loader = trainer.train_loader
    assert loader.row_selects == 1
    items = np.array([0, 29, 57, 100, 33, 28, 167, 5])
    dev = loader.get_batch(items)
    sp = trainer.splits["train"]
    ref = DynamicPairBatcher(sp["u"], sp["c"], sp["t"], 14, 2, stepper,
                             trainer.stats).get_batch(items)
    for k in ("input", "target"):
        assert dev[k].is_cuda
        want = torch.from_numpy(ref[k])
        torch.testing.assert_close(dev[k].cpu(), want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("conditional_norm", [False, True])
def test_sequential_trainer_card_vs_cpu(tmp_path, conditional_norm):
    """The fx SequentialTrainer's fit (fp32) on the card against the same
    fit on the CPU: the loss records and the three rollout errors within
    1e-3 relative; the card's steps and rollouts launch the kernels."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synthetic import make_sequential_fx_dataset

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train import SequentialTrainer

    make_sequential_fx_dataset(str(tmp_path / "seq.npz"))
    records, errors = {}, {}
    for dev in ("cuda", "cpu"):
        cfg = _seq_config(tmp_path, dev, "seq")
        if conditional_norm:
            cfg["model"]["use_conditional_norm"] = True
            cfg["model"]["args"]["transformer"]["attn_config"]["use_conditional_norm"] = True
        trainer = SequentialTrainer(json.loads(json.dumps(cfg)))
        kernels.reset_launches()
        trainer.fit(verbose=False)
        counts = kernels.launch_counts()
        if dev == "cuda":
            # 6 x 28 pairs at batch 16: 11 steps an epoch, 2 epochs, 2 layers.
            assert counts["flash_attention_bwd"] == 2 * 22
            # validation (56 pairs: 4 batches) and 7 + 1 + 4 rollout forwards
            assert counts["flash_attention_fwd"] == 2 * (4 + 12)
        else:
            assert not any(counts.values())
        records[dev] = np.load(tmp_path / dev / "loss.npz")
        errors[dev] = [trainer.datarow[f"relative error ({k})"]
                       for k in ("direct", "auto2", "auto4")]
    for k in ("losses", "val_losses"):
        np.testing.assert_allclose(records["cuda"][k], records["cpu"][k], rtol=1e-3)
    np.testing.assert_allclose(errors["cuda"], errors["cpu"], rtol=1e-3)


def test_vx_sequential_trainer_card_vs_cpu(tmp_path):
    """A vx sequential fit (fp32, a mesh per sample, batches that repeat a
    sample under two pairs) on the card against the CPU: the loss records
    and the rollout error within 1e-3 relative."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synthetic import make_sequential_vx_dataset

    from gaot_torch.core import metadata as meta
    from gaot_torch.train import SequentialTrainer

    make_sequential_vx_dataset(str(tmp_path / "seq_vx.npz"))
    meta.DATASET_METADATA["_test/seq_vx"] = meta.Metadata(
        periodic=False, group_u="u", group_c="c", group_x="x", type="gaot",
        domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=False,
        active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
        signed={"u": [True], "c": [True]}, names={"u": ["$u$"], "c": ["$c$"]},
        global_mean=[0.0], global_std=[1.0])
    records, errors = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            cfg = _seq_config(tmp_path, dev, "seq_vx", metaname="_test/seq_vx",
                              predict_mode="autoregressive", batch_size=8, test_size=2)
            trainer = SequentialTrainer(json.loads(json.dumps(cfg)))
            assert trainer.coord_mode == "vx"
            trainer.fit(verbose=False)
            records[dev] = np.load(tmp_path / dev / "loss.npz")
            errors[dev] = trainer.datarow["relative error (autoregressive)"]
    finally:
        del meta.DATASET_METADATA["_test/seq_vx"]
    for k in ("losses", "val_losses"):
        np.testing.assert_allclose(records["cuda"][k], records["cpu"][k], rtol=1e-3)
    np.testing.assert_allclose(errors["cuda"], errors["cpu"], rtol=1e-3)
