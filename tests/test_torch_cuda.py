"""gaot_torch's CUDA kernels against their plain versions on the card, at the
shapes the main path does not reach: GQA, ragged sequence and row counts,
channel counts without 16-byte vectors, coef staged in several k-chunks,
fp32 attention, and the small fx forward against the CPU plain route.

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
    n0 = mr.launches
    got = mr.multiply_reduce_k(coef, gath, b)
    torch.cuda.synchronize()
    assert mr.launches == n0 + 1
    _close(got, mr.multiply_reduce_k_plain(coef, gath, b), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hkv", [(2, 100, 8, 2), (1, 1, 4, 4),
                                       (3, 257, 6, 3)])
def test_flash_attention(dtype, b, s, h, hkv):
    from gaot_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(s + h)
    # Strided views of one packed projection, as the attention block makes.
    qkv = _rnd(gen, b, s, h + 2 * hkv, 32).to(dtype)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    _close(got, fa.attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("r,m,f", [(200, 256, 96), (64, 256, 1024), (1, 256, 32)])
def test_fused_ffn(r, m, f):
    from gaot_torch.ops.cuda import fused_ffn as ff

    gen = torch.Generator(device="cuda").manual_seed(r + f)
    x = _rnd(gen, r, m).bfloat16()
    w1 = (_rnd(gen, f, m) / m ** 0.5).bfloat16()
    w3 = (_rnd(gen, f, m) / m ** 0.5).bfloat16()
    w2 = (_rnd(gen, m, f) / f ** 0.5).bfloat16()
    got = ff.fused_ffn(x, w1, w3, w2)
    torch.cuda.synchronize()
    _close(got, ff.fused_ffn_plain(x, w1, w3, w2), torch.bfloat16)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    from gaot_torch.ops.cuda import flash_attention as fa
    from gaot_torch.ops.cuda import fused_ffn as ff

    q = torch.zeros(1, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                     # head dim 16
    x = torch.zeros(4, 256, device="cuda")
    w = torch.zeros(64, 256, device="cuda")
    with pytest.raises(TypeError):
        ff.fused_ffn(x, w, w, w.t().contiguous())       # fp32
    x, w = x[:, :128].bfloat16().contiguous(), w[:, :128].bfloat16().contiguous()
    with pytest.raises(ValueError):
        ff.fused_ffn(x, w, w, w.t().contiguous())       # M = 128
    q = torch.zeros(1, 8, 2, 32, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, q, q)                     # no backward yet


def test_auto_routes_raise_on_widths_the_kernels_do_not_take():
    """Under "auto" a CUDA tensor goes to the kernel's wrapper whatever its
    shape, so a head dim or FFN width the kernels were not built for raises
    instead of running the plain version on the card."""
    from gaot_torch.models.transformer import FFN, GroupQueryAttention

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = GroupQueryAttention(128, 128, num_heads=8, num_kv_heads=8,
                               backend="auto", device="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        attn(_rnd(gen, 2, 16, 128))                     # head dim 16
    ffn = FFN(128, 512, dtype=torch.bfloat16, fused="auto", device="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="built for M"):
        ffn(_rnd(gen, 2, 16, 128).bfloat16())           # M = 128


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_small_forward_card_vs_cpu(dtype):
    """A small fx GAOT (hidden 256, GQA with head dim 32, SwiGLU width 1024): every kernel launches
    and the card agrees with the CPU plain route (fp32: rtol 1e-3; bf16:
    relative L2 2e-2, bf16 rounds at other places on the CPU)."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.data.graph_builder import GraphBuilder, prepare_fx_device_graphs
    from gaot_torch.models import GAOT
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.static_trainer import FxGraphs, eval_step

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
    enc, dec = GraphBuilder().build_fx_graphs(coords, lat, 0.067, [1.0])
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
