"""Shared set-up for the gaot_torch parity tests: one tiny fx workload built
from a seed with NumPy, the JAX model with its weights, and the port's twin
with the same weights carried over (strict load)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

# Encoder graph [1024, 16] splits into degree buckets; the decoder graph
# [2000, 8] stays dense (K < 12) — the main path's layout at a small size
# (radius ≈ 1.04 latent spacings, mean encoder degree ≈ 7).
GRID = (32, 32)
NUM_NODES = 2000
RADIUS = 0.067
BATCH = 2
IN_CH, OUT_CH = 3, 2

MODEL_CFG = {
    "latent_tokens_size": list(GRID),
    "args": {
        "magno": {"coord_dim": 2, "radius": RADIUS, "hidden_size": 16,
                  "mlp_layers": 3, "lifting_channels": 8},
        "transformer": {"patch_size": 2, "hidden_size": 128, "num_layers": 3,
                        "attn_config": {"num_heads": 4, "num_kv_heads": 2}},
    },
}


def workload(seed: int = 0):
    """coords [N, 2], latent grid [Q, 2], pndata [B, N, Cin], target."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (NUM_NODES, 2)).astype(np.float32)
    ax = np.linspace(-1, 1, GRID[0])
    lat = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
    lat = lat.astype(np.float32)
    pndata = rng.normal(size=(BATCH, NUM_NODES, IN_CH)).astype(np.float32)
    target = rng.normal(size=(BATCH, NUM_NODES, OUT_CH)).astype(np.float32)
    return coords, lat, pndata, target


def configs():
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_tpu.core.config import ModelConfig as JModelConfig
    from gaot_tpu.core.config import merge_config as jmerge

    return jmerge(JModelConfig, MODEL_CFG), merge_config(ModelConfig, MODEL_CFG)


def jax_graphs(coords, lat, jcfg):
    from gaot_tpu.data.graph_builder import GraphBuilder, prepare_fx_device_graphs

    enc, dec = GraphBuilder().build_fx_graphs(coords, lat, RADIUS, [1.0])
    return prepare_fx_device_graphs(enc, dec, coords.shape[0], lat.shape[0],
                                    jcfg.args.magno)


def torch_graphs(coords, lat, tcfg):
    from gaot_torch.data.graph_builder import GraphBuilder, prepare_fx_device_graphs

    enc, dec = GraphBuilder().build_fx_graphs(coords, lat, RADIUS, [1.0])
    return prepare_fx_device_graphs(enc, dec, coords.shape[0], lat.shape[0],
                                    tcfg.args.magno, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_params():
    """The JAX GAOT's fp32 parameters (nested dict of NumPy arrays)."""
    from gaot_tpu.models import GAOT as JGAOT

    coords, lat, pndata, _ = workload()
    jcfg, _ = configs()
    enc, dec, enc_t, dec_t = jax_graphs(coords, lat, jcfg)
    model = JGAOT(input_size=IN_CH, output_size=OUT_CH, config=jcfg)
    params = jax.jit(model.init)(jax.random.key(0), jnp.asarray(lat),
                                 jnp.asarray(coords), jnp.asarray(pndata),
                                 enc, dec, encoder_tgraphs=enc_t,
                                 decoder_tgraphs=dec_t)
    return jax.tree.map(np.asarray, params)


def torch_model(dtype=None):
    """The port's GAOT on the CPU with the JAX weights."""
    from gaot_torch.models import GAOT
    from gaot_torch.utils.torch_interop import load_flax_params

    _, tcfg = configs()
    model = GAOT(IN_CH, OUT_CH, tcfg, dtype=dtype, device="cpu")
    load_flax_params(model, jax_params())
    return model.eval()


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def assert_same_graphs(jg, tg, path="graph"):
    """Walk a JAX and a port graph container (NamedTuples / tuples / arrays)
    in step: same types, shapes, dtypes (bool or not) and values."""
    if jg is None or tg is None:
        assert jg is None and tg is None, path
        return
    if isinstance(tg, torch.Tensor):
        ja = np.asarray(jg)
        assert tg.device.type == "cpu", path
        assert tuple(tg.shape) == ja.shape, path
        assert (tg.dtype == torch.bool) == (ja.dtype == np.bool_), path
        np.testing.assert_array_equal(tg.numpy(), ja, err_msg=path)
        return
    assert type(tg).__name__ == type(jg).__name__, path
    assert len(tg) == len(jg), path
    fields = getattr(tg, "_fields", range(len(tg)))
    for i, name in enumerate(fields):
        assert_same_graphs(jg[i], tg[i], f"{path}.{name}")
