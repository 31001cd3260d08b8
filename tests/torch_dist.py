"""Multi-process runs of the port for the CPU tests: ``run_ranks`` starts
``world`` processes (``torch.multiprocessing``, spawn), each joins a gloo
group through a ``file://`` store under the test's temporary folder (a
fixed TCP port would collide between xdist workers), runs one of the
functions below and returns what rank 0 (or every rank) returned. Every
child has a timeout. The functions run in one process too (``world`` 1,
no group): the one-process reference of the same code.

This module imports torch and the port only: the children never load JAX.
"""
from __future__ import annotations

import copy
import importlib
import os
import traceback
import uuid

import numpy as np
import torch

CHILD_TIMEOUT = 240.0


def _child(module: str, name: str, rank: int, world: int, store: str, out: str,
           args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        result = getattr(importlib.import_module(module), name)(rank, world, *args)
        torch.save(result, f"{out}.rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out}.rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = CHILD_TIMEOUT):
    """``fn(rank, world, *args)`` in ``world`` processes over gloo; returns
    the list of the ranks' results. A child that fails or outlives
    ``timeout`` seconds fails the call (every child is stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    store = str(tmp_path / f"store_{tag}")
    out = str(tmp_path / f"out_{tag}")
    procs = [ctx.Process(target=_child, args=(fn.__module__, fn.__name__, r, world,
                                              store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    import time

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = f"{out}.rank{r}.err"
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p in alive:
            errors.append(f"rank {r}: timed out after {timeout} s")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# Functions the ranks run
# ---------------------------------------------------------------------------

def _trainer(world: int, cfg: dict, weights=None):
    from gaot_torch.train import SequentialTrainer, StaticTrainer

    cfg = copy.deepcopy(cfg)
    cfg["setup"]["distributed"] = world > 1
    cls = (SequentialTrainer if cfg["setup"].get("trainer_name") == "sequential"
           else StaticTrainer)
    trainer = cls(cfg)
    if weights is not None:
        trainer.load_full_weights(torch.load(weights))
    return trainer


def full_grads(trainer):
    """Every parameter's gradient, the split ones joined over the model axis."""
    from gaot_torch.parallel.mesh import full_state_dict

    return {k: v.clone() for k, v in full_state_dict(
        {n: p.grad for n, p in trainer.model.named_parameters()},
        trainer.tp_specs, trainer.mesh).items()}


def train_steps(rank: int, world: int, cfg: dict, weights: str, steps: int):
    """``steps`` training steps on the first batches of the trainer's loader
    from ``weights``: (the losses, the first step's gradients as the
    optimizer sees them (after DDP), the full weights after the steps, the
    trainer's split weights)."""
    trainer = _trainer(world, cfg, weights)
    grads = []
    step = trainer.optimizer.step

    def capture(*a, **k):
        grads.append(full_grads(trainer))
        return step(*a, **k)

    trainer.optimizer.step = capture
    it = iter(trainer.train_loader)
    losses = [float(trainer.train_step(next(it))) for _ in range(steps)]
    return {"losses": losses, "grads": grads[0], "weights": trainer.full_state(),
            "specs": dict(trainer.tp_specs),
            "local_shapes": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}}


def evaluate(rank: int, world: int, cfg: dict, weights: str):
    """The validation loss and the test metric of ``weights``."""
    trainer = _trainer(world, cfg, weights)
    return {"val": trainer.validate(trainer.val_loader),
            "metric": trainer.test() if trainer.test_loader is not None else None}


def steps_and_evaluate(rank: int, world: int, cfg: dict, weights, steps: int,
                       flat: bool = False):
    """:func:`train_steps`, then :func:`evaluate` of ``weights`` in a new
    trainer (and, with ``flat``, :func:`vx_flat_share` first)."""
    out = {"flat": vx_flat_share(rank, world, cfg)} if flat else {}
    out.update(train_steps(rank, world, cfg, weights, steps))
    out["eval"] = evaluate(rank, world, cfg, weights)
    return out


def fit_cli(rank: int, world: int, cfg_path: str, load_cfg: dict = None):
    """``gaot_torch.cli.run_config(cfg_path)``: the trainer's datarow and
    full weights; with ``load_cfg``, then the full weights and update count
    of a trainer of that config after ``load_ckpt``."""
    from gaot_torch import cli

    trainer = cli.run_config(cfg_path)
    out = {"row": {k: v for k, v in trainer.datarow.items()
                   if isinstance(v, (int, float, str))},
           "weights": trainer.full_state()}
    if load_cfg is not None:
        out["loaded"] = load_ckpt_state(rank, world, load_cfg)
    return out


def masked_means(rank: int, world: int, pred, target, sample_mask, node_mask):
    """Rank r's share of a batch through ``global_masked_mse``: (the loss,
    the gradient of the prediction's share after the data-parallel mean,
    the mean of the ranks' own masked means)."""
    from gaot_torch.parallel import comm
    from gaot_torch.parallel.mesh import make_mesh, shard_batch
    from gaot_torch.train.static_trainer import global_masked_mse, masked_mse

    mesh = make_mesh(-1, 1)
    b = sample_mask.shape[0]
    share = shard_batch({"p": pred, "t": target, "sample_mask": sample_mask,
                         "node_mask": node_mask}, mesh, b)
    p = torch.from_numpy(share["p"]).requires_grad_()
    args = (torch.from_numpy(share["t"]), torch.from_numpy(share["sample_mask"]),
            None if node_mask is None else torch.from_numpy(share["node_mask"]))
    objective, loss = global_masked_mse(p, *args, mesh=mesh)
    objective.backward()
    grad = comm.all_gather(p.grad / mesh.dp, mesh.data_group, 0)[:b]
    own = comm.all_reduce(masked_mse(p.detach(), *args), mesh.data_group) / mesh.dp
    return float(loss), grad.numpy(), float(own)


def vx_flat_share(rank: int, world: int, cfg: dict):
    """A vx trainer's first training batch: this rank's flattened encoder
    and decoder graphs (``vx_flat_graphs``), as NumPy arrays."""
    trainer = _trainer(world, cfg)
    batch = trainer.place_batch(next(iter(trainer.train_loader)))
    graphs = trainer._batch_graphs(batch)

    def flat(g):
        return {"idx": [b.indices.numpy() for b in g.buckets],
                "mask": [b.mask.numpy() for b in g.buckets],
                "perm": None if g.perm is None else g.perm.numpy(),
                "inv_perm": None if g.inv_perm is None else g.inv_perm.numpy(),
                "rows": g.rows, "samples": g.num_samples}
    return {"enc": [flat(g) for g in graphs.encoder],
            "dec": [flat(g) for g in graphs.decoder],
            "x": batch["x"].numpy(), "samples": len(batch["sample_mask"]),
            "sources": {"enc": batch["x"].shape[1], "dec": trainer.latent.shape[0]}}


def save_weights(state: dict, path: str) -> str:
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}, path)
    return path


def load_ckpt_state(rank: int, world: int, cfg: dict):
    """The full weights and the update count after ``load_ckpt``."""
    trainer = _trainer(world, cfg)
    trainer.load_ckpt()
    return {"weights": trainer.full_state(), "step": trainer.step}


def spatial_model(rank: int, world: int, model_cfg: dict, weights: str, graphs,
                  inputs):
    """The port's GAOT with ``weights`` under spatial parallelism over the
    ``world`` ranks (one process: unsharded): the forward's full output,
    and every parameter's gradient of the mean squared error to the target
    (the sum of this rank's output queries' squares over the global count,
    the gradients summed over the ranks)."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.models import GAOT
    from gaot_torch.ops.padding import PaddedGraph
    from gaot_torch.parallel.mesh import make_mesh
    from gaot_torch.parallel.spatial import cut_rows, gather_nodes, spatial_shard, sum_grads

    lat, coords, pndata, target = (torch.from_numpy(a) for a in inputs)
    enc, dec = graphs
    cfg = merge_config(ModelConfig, model_cfg)
    model = GAOT(pndata.shape[-1], target.shape[-1], cfg, device="cpu")
    model.load_state_dict(torch.load(weights))
    mesh = make_mesh(1, world, spatial=True)
    shard = None
    if mesh.spatial:
        shard = spatial_shard(cfg.latent_tokens_size, cfg.args.transformer.patch_size,
                              coords.shape[0], mesh.model_group, mesh.model_index, mesh.mp)
        model.shard_queries(shard)
        enc, dec = cut_rows(enc, *shard.latent), cut_rows(dec, *shard.nodes)
        target = target[:, shard.nodes[0]:shard.nodes[1]]
    to_t = lambda g: PaddedGraph(torch.from_numpy(g.indices).long(),
                                 torch.from_numpy(g.mask))
    pred = model(lat, coords, pndata, [to_t(enc)], [to_t(dec)])
    count = float(np.prod(inputs[3].shape))
    ((pred - target) ** 2).sum().div(count).backward()
    sum_grads(model.parameters(), mesh.model_group)
    with torch.no_grad():
        full = gather_nodes(pred.detach(), shard, 1)
    return {"pred": full.numpy(),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()}}


def several(rank: int, world: int, calls, metadata: dict = None):
    """The functions of ``calls`` ((name, args) pairs, functions of this
    module) in turn, in one start of the ranks: the list of their results.
    ``metadata`` (name → ``Metadata`` keywords) is registered in the port's
    registry first."""
    from gaot_torch.core import metadata as tmeta

    for name, kw in (metadata or {}).items():
        tmeta.DATASET_METADATA[name] = tmeta.Metadata(**kw)
    return [globals()[fn](rank, world, *args) for fn, args in calls]


def spatial_vx_model(rank: int, world: int, model_cfg: dict, weights: str, x, lat,
                     pndata, target, bucketing: bool):
    """The port's vx GAOT with ``weights`` under spatial parallelism over the
    ``world`` ranks (one process: unsharded), on the vx graphs of the raw
    coordinates ``x`` [B, N, d] that the port's builder makes (each rank
    its cut): the forward's full output, the masked mean squared error to
    ``target`` over the real nodes of every rank, and every parameter's
    gradient of it (summed over the ranks)."""
    from gaot_torch.core.config import ModelConfig, merge_config
    from gaot_torch.data.graph_builder import (
        GraphBuilder,
        VxCounts,
        vx_flat_graphs,
        vx_graph_buffers,
        vx_layout,
        vx_node_pad,
    )
    from gaot_torch.models import GAOT
    from gaot_torch.parallel.mesh import make_mesh
    from gaot_torch.parallel.spatial import gather_nodes, spatial_shard, sum_grads
    from gaot_torch.train.static_trainer import global_masked_mse

    cfg = merge_config(ModelConfig, model_cfg)
    magno = cfg.args.magno
    mesh = make_mesh(1, world, spatial=True)
    splits = {"test": {"x": x}}
    n_pad, q = vx_node_pad(splits, False), lat.shape[0]
    shard, rows, counts = None, None, VxCounts(n_pad, q, q, n_pad)
    if mesh.spatial:
        shard = spatial_shard(cfg.latent_tokens_size, cfg.args.transformer.patch_size,
                              n_pad, mesh.model_group, mesh.model_index, mesh.mp)
        rows = (shard.latent, shard.nodes)
        counts = VxCounts(n_pad, q, shard.latent[1] - shard.latent[0],
                          shard.nodes[1] - shard.nodes[0])
    split = GraphBuilder(morton=True).build_all_vx_graphs(
        splits, lat, magno.radius, magno.scales, build_train=False,
        with_transpose=True, bucketing=bucketing, rows=rows)["test"]
    bufs = vx_graph_buffers(split)
    bufs.pop("node_perm")
    b = x.shape[0]
    batch = {k: torch.from_numpy(v) for k, v in
             {**bufs, **vx_layout(bufs, b, split.num_latent)}.items()}
    enc, dec = vx_flat_graphs(batch, len(magno.scales), counts)
    model = GAOT(pndata.shape[-1], target.shape[-1], cfg, device="cpu")
    model.load_state_dict(torch.load(weights))
    tgt, nmask = torch.from_numpy(target), batch["node_mask"]
    if shard is not None:
        model.shard_queries(shard._replace(widths=split.draw_widths))
        tgt, nmask = tgt[:, slice(*shard.nodes)], nmask[:, slice(*shard.nodes)]
    pred = model(torch.from_numpy(lat), batch["x"], torch.from_numpy(pndata), enc, dec)
    objective, loss = global_masked_mse(pred, tgt, torch.ones(b, dtype=torch.bool),
                                        nmask, mesh)
    objective.backward()
    sum_grads(model.parameters(), mesh.model_group)
    with torch.no_grad():
        full = gather_nodes(pred.detach(), shard, 1)
    return {"pred": full.numpy(), "loss": float(loss), "coords": split.coords,
            "node_mask": split.node_mask,
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()}}


def cache_runs(rank: int, world: int, cfg: dict, steps: int):
    """Two trainers of ``cfg`` in turn (its ``dataset.graph_cache_dir``
    set): for each, whether it hit the cache and the losses of ``steps``
    training steps."""
    import contextlib
    import io

    out = []
    for _ in range(2):
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            trainer = _trainer(world, cfg)
        it = iter(trainer.train_loader)
        out.append({"hit": "Graph cache hit" in said.getvalue(),
                    "losses": [float(trainer.train_step(next(it))) for _ in range(steps)]})
    return out


def epoch_and_per_step(rank: int, world: int, cfg: dict, weights=None, epochs: int = 2):
    """Two trainers of ``cfg`` (``setup.epoch_scan`` "always", on the CPU)
    from ``weights`` (else the seed's, the same in both): ``epochs`` epochs
    through the epoch path (``EpochProgram``, uncaptured), and through the
    per-step path (``train_step`` on each batch of the loader). Returns the
    route, whether the loader had device buffers, and each way's losses,
    full weights after and generator state."""
    from gaot_torch.train.graphed import EpochProgram

    a = _trainer(world, cfg, weights)
    b = _trainer(world, cfg, weights)
    out = {"route": a.steps_route(), "device_buffers": a.train_loader.device_epoch_spec
           is not None}
    program = EpochProgram(a, capture=False)
    epoch, step = [], []
    for _ in range(epochs):
        epoch += a.train_epoch(program)[0].tolist()
        step += [float(b.train_step(batch)) for batch in b.train_loader]
    for way, trainer, losses in (("epoch", a, epoch), ("step", b, step)):
        out[way] = {"losses": losses, "weights": trainer.full_state(),
                    "rng": trainer.generator.get_state(), "updates": trainer.step}
    return out
