"""Weight carry from the JAX package's parameters to the port.

A copy of ``gaot_tpu/utils/torch_interop.py``'s mapping (flax path → the
original PyTorch GAOT ``state_dict`` name), taking a nested dict of NumPy
arrays, so the port reads JAX weights without importing JAX. The port's
modules carry exactly those names, so :func:`load_flax_params` is a strict
``load_state_dict``.

Transforms per entry kind:
- linear:  torch ``weight [out, in]`` = flax ``kernel [in, out]``.T
- conv1d:  torch ``weight [out, in, 1]`` = flax ``kernel``.T[..., None]
- norm:    torch ``weight`` = flax ``weight`` (RMSNorm)
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Entry = Tuple[Tuple[str, ...], str, str]  # (flax path, torch prefix, kind)


def _dense_ids(subtree: dict, stem: str = "dense_") -> List[int]:
    return sorted(int(k.split("_")[1]) for k in subtree if k.startswith(stem))


def mapping_entries(params) -> List[Entry]:
    """The (flax path, torch name prefix, kind) table for this param tree."""
    p = params.get("params", params)
    ents: List[Entry] = []

    def magno(side: str, final_name: str):
        sub = p[side]
        for i in _dense_ids(sub["agno"]["channel_mlp"]):
            ents.append(((side, "agno", "channel_mlp", f"dense_{i}"),
                         f"{side}.agno.channel_mlp.fcs.{i}", "linear"))
        for proj in ("query_proj", "key_proj"):   # dot-product attention
            if proj in sub["agno"]:
                ents.append(((side, "agno", proj),
                             f"{side}.agno.{proj}", "linear"))
        for i in _dense_ids(sub[final_name]):
            ents.append(((side, final_name, f"dense_{i}"),
                         f"{side}.{final_name}.fcs.{i}", "conv1d"))
        if "geoembed" in sub:
            g = sub["geoembed"]
            if "stat_dense0" in g:
                ents.append(((side, "geoembed", "stat_dense0"),
                             f"{side}.geoembed.mlp.0", "linear"))
                ents.append(((side, "geoembed", "stat_dense1"),
                             f"{side}.geoembed.mlp.2", "linear"))
            else:                                  # pointnet
                ents.append(((side, "geoembed", "pointnet_mlp", "dense_0"),
                             f"{side}.geoembed.pointnet_mlp.0", "linear"))
                ents.append(((side, "geoembed", "pointnet_mlp", "dense_1"),
                             f"{side}.geoembed.pointnet_mlp.2", "linear"))
                ents.append(((side, "geoembed", "fc"),
                             f"{side}.geoembed.fc.0", "linear"))
            for i in _dense_ids(sub["recovery"]):
                ents.append(((side, "recovery", f"dense_{i}"),
                             f"{side}.recovery.fcs.{i}", "conv1d"))
        if "scale_weighting" in sub:
            # reference nn.Sequential(Linear, ReLU, Linear) → indices 0, 2
            ents.append(((side, "scale_weighting", "fc0"),
                         f"{side}.scale_weighting.0", "linear"))
            ents.append(((side, "scale_weighting", "fc1"),
                         f"{side}.scale_weighting.2", "linear"))

    magno("encoder", "lifting")
    magno("decoder", "projection")
    ents.append((("patch_linear",), "patch_linear", "linear"))

    proc = p["processor"]
    if "input_proj" in proc:
        ents.append((("processor", "input_proj"),
                     "processor.input_proj", "linear"))
    if "output_proj" in proc:
        ents.append((("processor", "output_proj"),
                     "processor.output_proj", "linear"))

    def block(flax_name: str, torch_name: str, skip: bool):
        b = proc[flax_name]
        base = ("processor", flax_name)
        for norm in ("attn_norm", "ffn_norm"):
            if norm in b:
                ents.append((base + (norm,),
                             f"processor.{torch_name}.{norm}", "norm"))
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            ents.append((base + ("attn", proj),
                         f"processor.{torch_name}.attn.{proj}", "linear"))
        for w in ("w1", "w2", "w3"):
            ents.append((base + ("ffn", w),
                         f"processor.{torch_name}.ffn.{w}", "linear"))
        for mod in ("attn", "ffn"):           # time-conditional norm
            if "correction" in b.get(mod, {}):
                for m in ("mlp_scale", "mlp_bias"):
                    # reference MLP(num_layers=2) is a single Linear in a
                    # ModuleList (mlp.py:49-52) → '<m>.layers.0'
                    ents.append(
                        (base + (mod, "correction", m, "Dense_0"),
                         f"processor.{torch_name}.{mod}.correction.{m}"
                         f".layers.0", "linear"))
        if skip and "skip_proj" in b:
            ents.append((base + ("skip_proj",),
                         f"processor.{torch_name}.skip_proj", "linear"))

    for i in _dense_ids(proc, "encoder_"):
        block(f"encoder_{i}", f"encoder_layers.{i}", skip=False)
    if "middle" in proc:
        block("middle", "middle_layer", skip=False)
    for i in _dense_ids(proc, "decoder_"):
        block(f"decoder_{i}", f"decoder_layers.{i}", skip=True)
    return ents


def _get(p: dict, path: Tuple[str, ...]) -> dict:
    for k in path:
        p = p[k]
    return p


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def _check_coverage(p: dict, ents: List[Entry]) -> None:
    covered = set()
    for path, _, kind in ents:
        sub = _get(p, path)
        names = ("weight",) if kind == "norm" else tuple(sub.keys())
        for n in names:
            covered.add(path + (n,))
    missing = ["/".join(q) for q in _leaf_paths(p) if q not in covered]
    if missing:
        raise ValueError(
            "params not covered by the torch mapping (model config uses "
            f"features outside the interop surface): {missing}")


def flax_to_torch_state_dict(params) -> Dict[str, np.ndarray]:
    """Flax params → reference torch state dict (NumPy values)."""
    p = params.get("params", params)
    ents = mapping_entries(params)
    _check_coverage(p, ents)
    sd: Dict[str, np.ndarray] = {}
    for path, name, kind in ents:
        sub = _get(p, path)
        if kind == "norm":
            sd[f"{name}.weight"] = np.asarray(sub["weight"]).copy()
            continue
        w = np.asarray(sub["kernel"]).T.copy()
        sd[f"{name}.weight"] = w[..., None] if kind == "conv1d" else w
        if "bias" in sub:
            sd[f"{name}.bias"] = np.asarray(sub["bias"]).copy()
    return sd


def load_flax_params(model: torch.nn.Module, params) -> None:
    """Load JAX-package parameters (a nested dict of NumPy arrays, with or
    without the top-level "params" key) into ``model``, strictly: a missing
    or unexpected name raises."""
    sd = flax_to_torch_state_dict(params)
    device = next(model.parameters()).device
    model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(device)
         for k, v in sd.items()}, strict=True)
