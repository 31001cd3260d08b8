"""gaot_torch modules against gaot_tpu on the CPU, with carried weights.

Every module runs on the same seeded inputs and graphs in both packages.
fp32 tolerance: rtol 1e-4 / atol 1e-5 — both sides compute in fp32 and
differ only in summation order and transcendental rounding (the JAX package
reached ~1e-5 against the original PyTorch GAOT on the same check).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def setup():
    coords, lat, pndata, target = tp.workload()
    jcfg, tcfg = tp.configs()
    jg = tp.jax_graphs(coords, lat, jcfg)
    tg = tp.torch_graphs(coords, lat, tcfg)
    from gaot_tpu.models import GAOT as JGAOT

    jmodel = JGAOT(input_size=tp.IN_CH, output_size=tp.OUT_CH, config=jcfg)
    return dict(coords=coords, lat=lat, pndata=pndata, target=target,
                jg=jg, tg=tg, jmodel=jmodel, params=tp.jax_params(),
                tmodel=tp.torch_model())


def _japply(s, fn, *args):
    return np.asarray(s["jmodel"].apply(s["params"], *args, method=fn))


def test_strict_weight_carry(setup):
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict

    model = setup["tmodel"]
    sd = flax_to_torch_state_dict(setup["params"])
    assert set(sd) == set(model.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(tp.to_np(model.state_dict()[k]), v)
    with pytest.raises(RuntimeError):
        model.load_state_dict({**{k: torch.from_numpy(v) for k, v in sd.items()},
                               "encoder.extra.weight": torch.zeros(1)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mlp_gelu_modes(dtype):
    """Exact erf GELU in fp32, tanh GELU in bf16, on both sides."""
    from gaot_torch.models.mlp import ChannelMLP
    from gaot_tpu.models.mlp import ChannelMLP as JChannelMLP

    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 50, 6)).astype(np.float32) * 2
    jm = JChannelMLP(out_channels=5, hidden_channels=12, n_layers=3, dtype=jdt)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(1), jnp.asarray(x)))
    want = np.asarray(jm.apply(params, jnp.asarray(x)).astype(jnp.float32))
    tm = ChannelMLP(6, 5, hidden_channels=12, n_layers=3, dtype=tdt, device="cpu")
    with torch.no_grad():
        for i, fc in enumerate(tm.fcs):
            p = params["params"][f"dense_{i}"]
            fc.weight.copy_(torch.tensor(p["kernel"].T[..., None]))
            fc.bias.copy_(torch.tensor(p["bias"]))
        got = tp.to_np(tm(torch.from_numpy(x)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        # bf16 rounds at different places in XLA and PyTorch: one bf16 ulp.
        assert tp.rel_l2(got, want) < 1e-2


def test_agno_bucketed_route(setup):
    s = setup
    rng = np.random.default_rng(2)
    f = rng.normal(size=(tp.BATCH, tp.NUM_NODES, 8)).astype(np.float32)
    jbg, tbg = s["jg"][0][0], s["tg"][0][0]
    jx = jnp.asarray(s["lat"])[jbg.perm]
    want = _japply(s, lambda m, y, g, x, fy: m.encoder.agno(y, g, x=x, f_y=fy),
                   jnp.asarray(s["coords"]), jbg, jx, jnp.asarray(f))
    with torch.no_grad():
        tx = torch.from_numpy(s["lat"]).index_select(0, tbg.perm)
        got = s["tmodel"].encoder.agno(torch.from_numpy(s["coords"]), tbg, x=tx,
                                       f_y=torch.from_numpy(f))
    assert got.shape == want.shape
    np.testing.assert_allclose(tp.to_np(got), want, rtol=RTOL, atol=ATOL)


def test_agno_dense_tgraph_route(setup):
    s = setup
    rng = np.random.default_rng(3)
    f = rng.normal(size=(tp.BATCH, s["lat"].shape[0], 8)).astype(np.float32)
    jd, jdt = s["jg"][1][0], s["jg"][3][0]
    td, tdt = s["tg"][1][0], s["tg"][3][0]
    want = _japply(s, lambda m, y, g, x, fy, t: m.decoder.agno(
        y, g, x=x, f_y=fy, tgraph=t), jnp.asarray(s["lat"]), jd,
        jnp.asarray(s["coords"]), jnp.asarray(f), jdt)
    with torch.no_grad():
        got = s["tmodel"].decoder.agno(torch.from_numpy(s["lat"]), td,
                                       x=torch.from_numpy(s["coords"]),
                                       f_y=torch.from_numpy(f), tgraph=tdt)
    np.testing.assert_allclose(tp.to_np(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_geometric_embedding(setup, side):
    """Statistical embedding over the bucketed encoder graph (valid-row
    standardization) and the dense decoder graph."""
    s = setup
    coords, lat = s["coords"], s["lat"]
    if side == "encoder":
        jgr, tgr = s["jg"][0][0], s["tg"][0][0]
        src, dst_j = coords, jnp.asarray(lat)[jgr.perm]
        dst_t = torch.from_numpy(lat).index_select(0, tgr.perm)
    else:
        jgr, tgr = s["jg"][1][0], s["tg"][1][0]
        src, dst_j, dst_t = lat, jnp.asarray(coords), torch.from_numpy(coords)
    want = _japply(s, lambda m, a, b, g: getattr(m, side).geoembed(a, b, g),
                   jnp.asarray(src), dst_j, jgr)
    with torch.no_grad():
        got = getattr(s["tmodel"], side).geoembed(torch.from_numpy(src), dst_t, tgr)
    np.testing.assert_allclose(tp.to_np(got), want, rtol=RTOL, atol=ATOL)


def test_magno_encoder(setup):
    s = setup
    enc_j, _, enc_tj, _ = s["jg"]
    enc_t, _, enc_tt, _ = s["tg"]
    want = _japply(s, lambda m, *a: m.encoder(*a[:4], tgraphs=a[4]),
                   jnp.asarray(s["coords"]), jnp.asarray(s["pndata"]),
                   jnp.asarray(s["lat"]), enc_j, enc_tj)
    with torch.no_grad():
        got = s["tmodel"].encoder(torch.from_numpy(s["coords"]),
                                  torch.from_numpy(s["pndata"]),
                                  torch.from_numpy(s["lat"]), enc_t,
                                  tgraphs=enc_tt)
    np.testing.assert_allclose(tp.to_np(got), want, rtol=RTOL, atol=ATOL)


def test_magno_decoder(setup):
    s = setup
    _, dec_j, _, dec_tj = s["jg"]
    _, dec_t, _, dec_tt = s["tg"]
    rng = np.random.default_rng(4)
    rndata = rng.normal(size=(tp.BATCH, s["lat"].shape[0], 8)).astype(np.float32)
    want = _japply(s, lambda m, *a: m.decoder(*a[:4], tgraphs=a[4]),
                   jnp.asarray(s["lat"]), jnp.asarray(rndata),
                   jnp.asarray(s["coords"]), dec_j, dec_tj)
    with torch.no_grad():
        got = s["tmodel"].decoder(torch.from_numpy(s["lat"]),
                                  torch.from_numpy(rndata),
                                  torch.from_numpy(s["coords"]), dec_t,
                                  tgraphs=dec_tt)
    np.testing.assert_allclose(tp.to_np(got), want, rtol=RTOL, atol=ATOL)


def test_uvit_transformer(setup):
    """3-layer UViT (encoder, middle, decoder with the long-range skip),
    GQA with 4 query and 2 KV heads."""
    s = setup
    rng = np.random.default_rng(5)
    tokens = rng.normal(size=(tp.BATCH, 256, 32)).astype(np.float32)
    want = _japply(s, lambda m, t: m.processor(t), jnp.asarray(tokens))
    with torch.no_grad():
        got = s["tmodel"].processor(torch.from_numpy(tokens))
    np.testing.assert_allclose(tp.to_np(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid,patch", [((8, 6), 2), ((4, 4, 8), 2)])
def test_patchify_unpatchify_exact(grid, patch):
    from gaot_torch.models.gaot import patchify, unpatchify
    from gaot_tpu.models import gaot as jgaot

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, int(np.prod(grid)), 3)).astype(np.float32)
    want = np.asarray(jgaot.patchify(jnp.asarray(x), grid, patch))
    got = patchify(torch.from_numpy(x), grid, patch).numpy()
    np.testing.assert_array_equal(got, want)
    back = unpatchify(torch.from_numpy(got), grid, patch, 3).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jgaot.unpatchify(jnp.asarray(want), grid, patch, 3)))


@pytest.mark.parametrize("name", ["masked_sum", "masked_mean", "masked_max",
                                  "masked_softmax"])
def test_segment_ops_match(name):
    """The masked reductions over a padded K axis, with an empty row (fp32:
    the same arithmetic, summation order only)."""
    from gaot_torch.ops import segment_ops as tops
    from gaot_tpu.ops import segment_ops as jops

    rng = np.random.default_rng(7)
    mask = rng.random((6, 5)) < 0.6
    mask[2] = False
    x = rng.normal(size=(6, 5) if name == "masked_softmax" else (6, 5, 3))
    x = (x * 3).astype(np.float32)
    want = np.asarray(getattr(jops, name)(jnp.asarray(x), jnp.asarray(mask)))
    got = getattr(tops, name)(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
