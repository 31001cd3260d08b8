"""The process mesh: data and tensor parallelism over ``torch.distributed``.

Counterpart of ``gaot_tpu/parallel/mesh.py``. Where the JAX package lays its
devices out as a ('data', 'model') mesh and lets XLA insert the
collectives, here each rank is one process and the collectives are written
out:

- :func:`init_distributed` joins the process group (torchrun's environment,
  or the config's coordinator address, process count and id);
- :func:`make_mesh` lays the ranks out as a dp × mp grid in the row-major
  order of JAX's ``np.asarray(devices).reshape(dp, mp)`` and makes the
  data-axis and model-axis groups;
- :func:`shard_batch` keeps this rank's contiguous share of a batch's
  leading axis (fx graphs stay whole on every rank);
- :func:`param_specs` names the transformer weights split over the model
  axis (the JAX rules keyed on the port's state-dict names), and
  :func:`shard_model`, :func:`full_state_dict` and :func:`load_full_state`
  split and join them.

A data-parallel step draws its edge drop and attention dropout through
``ops/draws.py::BatchShare``, so that it uses the masks of the one-process
step.

A mesh of one rank needs no process group: every group is None and every
collective returns its input (``parallel/comm.py``).
"""
from __future__ import annotations

import os
import re
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm


def init_distributed(setup, backend: Optional[str] = None) -> None:
    """Join the process group when ``setup.distributed`` is set; an existing
    group is kept as it is.

    The rendezvous is ``setup.coordinator_address`` (``host:port`` or a
    URL) with ``num_processes`` and ``process_id`` where the config sets
    them, else torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
    ``WORLD_SIZE``. The backend is ``backend``, else NCCL on the card and
    gloo where ``setup.device`` is "cpu". On the card the process takes
    device ``LOCAL_RANK`` (0 where unset)."""
    if dist.is_initialized() or not setup.distributed:
        return
    env = os.environ
    rank = setup.process_id if setup.process_id is not None else env.get("RANK")
    world = (setup.num_processes if setup.num_processes is not None
             else env.get("WORLD_SIZE"))
    if setup.coordinator_address:
        addr = setup.coordinator_address
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    else:
        raise ValueError(
            "setup.distributed needs a rendezvous: launch with torchrun (MASTER_ADDR, "
            "MASTER_PORT, RANK, WORLD_SIZE) or set setup.coordinator_address, "
            "num_processes and process_id")
    if rank is None or world is None:
        raise ValueError("setup.distributed needs the rank and the world size: "
                         "RANK and WORLD_SIZE, or setup.process_id and num_processes")
    on_cpu = setup.device == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(f"setup.device {setup.device!r} needs a CUDA device and "
                               "torch.cuda.is_available() is false")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend or ("gloo" if on_cpu else "nccl"),
                            init_method=init_method, rank=int(rank),
                            world_size=int(world))


class Mesh(NamedTuple):
    """This rank's place in the dp × mp grid (rank = data index · mp + model
    index) and its groups: ``data_group`` the ranks of its model index
    (DDP's group), ``model_group`` those of its data index (tensor or
    spatial parallelism); None where the axis has one rank."""

    world: int
    rank: int
    dp: int
    mp: int
    data_index: int
    model_index: int
    data_group: object = None
    model_group: object = None
    world_group: object = None
    spatial: bool = False

    @property
    def trivial(self) -> bool:
        return self.world == 1

    @property
    def loss_group(self):
        """The ranks whose samples and queries make up one step's loss: the
        data axis, and the model axis too when it carries the queries."""
        return self.world_group if self.spatial else self.data_group


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              spatial: bool = False) -> Mesh:
    """The dp × mp mesh over the process group's ranks (one rank without a
    group). ``data_parallel`` -1 means world size // ``model_parallel``.
    Unlike the JAX package, which leaves devices idle, dp × mp must equal
    the world size (an idle rank has no use here). Every rank makes every
    group, in one order, as ``dist.new_group`` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mp = model_parallel
    if mp < 1 or world % mp:
        raise ValueError(f"model_parallel={mp} must divide the world size {world}")
    dp = world // mp if data_parallel == -1 else data_parallel
    if dp * mp != world:
        raise ValueError(f"data_parallel × model_parallel = {dp} × {mp} must equal the "
                         f"world size {world} (one process per device)")
    d, m = divmod(rank, mp)
    data_group = model_group = world_group = None
    if world > 1:
        world_group = dist.group.WORLD
        for mi in range(mp):
            g = dist.new_group([di * mp + mi for di in range(dp)]) if dp > 1 else None
            if mi == m:
                data_group = g
        for di in range(dp):
            g = dist.new_group([di * mp + mi for mi in range(mp)]) if mp > 1 else None
            if di == d:
                model_group = g
    return Mesh(world, rank, dp, mp, d, m, data_group, model_group, world_group,
                spatial and mp > 1)


# ---------------------------------------------------------------------------
# The batch
# ---------------------------------------------------------------------------

def _pad_rows(v, n: int):
    """``v`` with its leading axis padded to ``n`` by wrapping around."""
    if v.shape[0] == n:
        return v
    reps = [v] * (-(-n // v.shape[0]))
    cat = np.concatenate(reps) if isinstance(v, np.ndarray) else torch.cat(reps)
    return cat[:n]


def shard_batch(batch: Dict, mesh: Mesh, batch_size: int) -> Dict:
    """This rank's share of a batch dict: every array with ``batch_size``
    leading rows keeps rows [d·Bl, (d+1)·Bl) (Bl = ⌈batch_size / dp⌉; a
    batch dp does not divide is first padded by wrapping around, with
    ``sample_mask`` False there). Of a vx batch's layout
    (``data/graph_builder.py::vx_layout``, the same in every batch) the
    rows' maps ``*_rmap_*``, sample-major from sample 0, keep their first
    Bl samples' entries and ``iota`` stays whole, as do the arrays of other
    lengths (the fx graphs)."""
    if mesh.dp == 1:
        return batch
    bl = -(-batch_size // mesh.dp)
    lo = mesh.data_index * bl
    out = {}
    for k, v in batch.items():
        if k == "iota":
            out[k] = v
        elif "_rmap_" in k:
            out[k] = v[:len(v) // batch_size * bl]
        elif hasattr(v, "shape") and v.ndim >= 1 and v.shape[0] == batch_size:
            padded = _pad_rows(v, bl * mesh.dp)
            if k == "sample_mask" and padded is not v:
                padded = padded.copy()
                padded[batch_size:] = False
            out[k] = padded[lo:lo + bl]
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism of the UViT
# ---------------------------------------------------------------------------

# State-dict names → the dimension split over the model axis. A torch weight
# is [out, in]: the JAX rule P(None, "model") on a flax kernel [in, out] (the
# QKV and SwiGLU up-projections' outputs) splits dim 0, P("model", None)
# (the output and down projections' inputs) dim 1.
_TP_RULES = [
    (re.compile(r"processor\..*\.attn\.(q_proj|k_proj|v_proj)\.weight$"), 0),
    (re.compile(r"processor\..*\.attn\.o_proj\.weight$"), 1),
    (re.compile(r"processor\..*\.ffn\.(w1|w3)\.weight$"), 0),
    (re.compile(r"processor\..*\.ffn\.w2\.weight$"), 1),
]


def param_specs(shapes: Dict[str, Tuple[int, ...]], model_parallel: int) -> Dict[str, int]:
    """The weights split over a model axis of ``model_parallel`` ranks:
    name → the split dimension, for every name of ``shapes`` (name →
    shape) that a rule matches and whose dimension ``model_parallel``
    divides (as the JAX package's ``shard_params`` keeps the others whole);
    {} for one rank."""
    if model_parallel <= 1:
        return {}
    out = {}
    for name, shape in shapes.items():
        for pattern, dim in _TP_RULES:
            if pattern.search(name) and len(shape) == 2 and \
                    shape[dim] % model_parallel == 0:
                out[name] = dim
    return out


def shard_model(model: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Split the UViT's attention heads and SwiGLU columns over the model
    axis, in place: each rank keeps num_heads/mp query heads, num_kv_heads/mp
    KV heads and ffn_hidden_size/mp SwiGLU columns; ``o_proj`` and ``w2``
    become row-parallel, their partial outputs summed by the modules'
    all-reduce (``comm.reduce_from_group``). A block whose heads or width mp
    does not divide stays whole. Returns the specs used (name → dim), which
    :func:`full_state_dict` and :func:`load_full_state` read."""
    from ..models.transformer import FFN, GroupQueryAttention

    if mesh.mp == 1 or mesh.spatial:
        return {}
    specs = param_specs({k: tuple(v.shape) for k, v in model.state_dict().items()},
                        mesh.mp)
    used: Dict[str, int] = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, GroupQueryAttention):
            if mod.num_heads % mesh.mp or mod.num_kv_heads % mesh.mp:
                continue
            names = ("q_proj", "k_proj", "v_proj", "o_proj")
        elif isinstance(mod, FFN):
            if mod.ffn_hidden_size % mesh.mp:
                continue
            names = ("w1", "w3", "w2")
        else:
            continue
        keys = [f"{prefix}.{n}.weight" for n in names]
        if not all(k in specs for k in keys):
            continue
        for n, k in zip(names, keys):
            dense = getattr(mod, n)
            dense.weight = torch.nn.Parameter(
                _shard(dense.weight.data, specs[k], mesh).clone())
            used[k] = specs[k]
        mod.shard_over(mesh.model_group, mesh.model_index, mesh.mp)
    return used


def _shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.mp
    return t.narrow(dim, mesh.model_index * n, n)


def full_state_dict(state: Dict[str, torch.Tensor], specs: Dict[str, int],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A sharded ``state_dict`` with its split weights joined over the
    model axis (a collective: every rank of the model group calls it)."""
    if not specs:
        return state
    return {k: comm.all_gather(v.contiguous(), mesh.model_group, specs[k])
            if k in specs else v for k, v in state.items()}


def load_full_state(state: Dict[str, torch.Tensor], specs: Dict[str, int],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` cut to this rank's shards."""
    if not specs:
        return state
    return {k: _shard(v, specs[k], mesh).clone() if k in specs else v
            for k, v in state.items()}


def optimizer_specs(model: torch.nn.Module, specs: Dict[str, int]) -> Dict[int, int]:
    """The optimizer state's parameter ids (the order of
    ``model.parameters()``) → the split dimension."""
    return {i: specs[n] for i, (n, _) in enumerate(model.named_parameters())
            if n in specs}


def full_optimizer_state(state: Dict, ids: Dict[int, int], mesh: Mesh) -> Dict:
    """An optimizer ``state_dict`` with its split tensors joined."""
    if not ids:
        return state
    out = dict(state, state={})
    for i, st in state["state"].items():
        out["state"][i] = {k: comm.all_gather(v.contiguous(), mesh.model_group, ids[i])
                           if i in ids and torch.is_tensor(v) and v.dim() > 0 else v
                           for k, v in st.items()}
    return out


def load_full_optimizer_state(state: Dict, ids: Dict[int, int], mesh: Mesh) -> Dict:
    """A full optimizer ``state_dict`` cut to this rank's shards."""
    if not ids:
        return state
    out = dict(state, state={})
    for i, st in state["state"].items():
        out["state"][i] = {k: _shard(v, ids[i], mesh).clone()
                           if i in ids and torch.is_tensor(v) and v.dim() > 0 else v
                           for k, v in st.items()}
    return out
