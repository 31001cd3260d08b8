"""The epoch path: ``setup.epoch_scan`` on the card.

Counterpart of the JAX trainers' whole-epoch scan
(``gaot_tpu/train/base_trainer.py::_build_epoch_fn``, ``train_epoch_scan``
and the decision in ``fit``). There, with device-resident data, one
dispatch runs a whole epoch on any mesh: each step gathers its batch from
the split's buffers on the device, runs the forward, the backward and the
update. Under PyTorch the same is, on each rank's card, one training step
captured once as a CUDA graph, with its NCCL collectives under several
ranks, and replayed for every step of every epoch:

- :class:`CapturedStep` captures a step that reads its inputs from static
  tensors: a few steps first on a side stream (the recipe of PyTorch's
  whole-network capture: the kernels are built and loaded, the optimizer's
  state and the caching allocator's blocks exist; where DDP wraps the
  model, the eleven its recipe asks for), whose effects on the
  weights, the optimizer state and the generators are then undone, so a
  fit that takes the graph trains as the per-step fit does; the step's
  draws (edge drop, attention dropout) come from generators registered
  with the graph, each replay moving their Philox offsets on as an eager
  step does;
- :class:`EpochProgram` is the trainer's step over an epoch's tables: the
  [k, B] sample indices and mask of
  :meth:`~gaot_torch.data.loader.BatchLoader.epoch_index_matrix`, the [k]
  schedule values (:func:`~gaot_torch.train.schedules.lr_table`) and a
  step counter on the device; each step reads row t (under several ranks
  this rank's columns of it), gathers the batch (the loader's
  ``device_epoch_spec``, or under several ranks its ``host_buffers``
  placed on the card), runs the trainer's step body
  (``StaticTrainer.step_body``, the one the per-step path runs) and writes
  its loss into slot t of a [k] buffer. The host copies the tables in
  once an epoch and replays k times. With ``setup.device: cpu`` the same
  body runs uncaptured;
- :class:`RolloutProgram` is one predict mode's rollout captured as one
  graph and replayed for each test batch (the JAX rollout's one
  ``lax.scan``).

:func:`choose_route` is the decision of ``fit``. Nothing here catches a
failure of a capture or a replay: it is raised.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loader import device_spec, epoch_path_reason
from ..models.rollout import rollout_constants, rollout_steps
from ..parallel.mesh import shard_batch

# Steps a fit must take before ``epoch_scan: "auto"`` captures its step:
# what the graph's first epoch (two warm-up steps and the capture) costs
# over the per-step route's, over what each later replayed step saves,
# measured by ``chip_smoke.py`` phase 11.4 on the fx recipe through the CLI
# in a fresh process (82 and 114 steps in two runs on an H100 80GB HBM3 at
# 700 W; PERF.md §6): the larger. The same measure of the step captured
# under DDP (phase 12c, eleven warm-up steps) read 113, 24 and 84 steps in
# three fresh torchrun processes: within it, so several ranks share it.
GRAPH_BREAK_EVEN_STEPS = 114
# Eager steps before a capture (PyTorch's whole-network recipe warms up on
# a side stream).
WARMUP_STEPS = 2
# The same where DDP wraps the model: PyTorch's CUDA-graph notes ("Usage
# with DistributedDataParallel") ask for at least 11 DDP iterations before
# a full-backward capture (DDP's reducer times its first 10 iterations with
# CUDA events, which a capture cannot hold).
DDP_WARMUP_STEPS = 11


def choose_route(epoch_scan, device: torch.device, world: int, loader,
                 steps: int) -> Tuple[str, str]:
    """(route, why) of a fit of ``steps`` training steps over ``world``
    ranks: "graph" (the epoch path captured on the card), "epoch" (the
    epoch path uncaptured: ``setup.device: cpu`` under "always") or
    "per-step"; ``why`` says why not the graph ("" where it is taken).
    "never" steps one by one; "always" takes the epoch path wherever its
    batches can be gathered on the device
    (:func:`~gaot_torch.data.loader.epoch_path_reason`; the JAX package's
    scan where ``_build_epoch_fn`` builds one) and else steps one by one,
    as the JAX package's ``fit`` does; "auto" takes the graph where it can
    and where the fit is long enough to repay the capture
    (:data:`GRAPH_BREAK_EVEN_STEPS`), else steps one by one."""
    mode = str(epoch_scan).lower()
    mode = {"true": "always", "false": "never"}.get(mode, mode)   # the JAX spellings
    if mode == "never":
        return "per-step", "setup.epoch_scan never"
    why = epoch_path_reason(loader, world)
    if why:
        return "per-step", why
    if device.type != "cuda":
        if mode == "always":
            return "epoch", "setup.device cpu: the step body uncaptured"
        return "per-step", "setup.device cpu: no CUDA graph"
    if mode == "auto" and steps < GRAPH_BREAK_EVEN_STEPS:
        return "per-step", (f"{steps} steps, below the capture's break-even of "
                            f"{GRAPH_BREAK_EVEN_STEPS}")
    return "graph", ""


class Snapshot:
    """Copies of the weights, the optimizer state and the generators'
    states, written back in place (a graph holds the tensors it was
    captured with): what the warm-up steps before a capture changed is
    undone. A parameter with no optimizer state before gets a zero one,
    which takes the first update as a fresh state does."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 generators: Sequence[torch.Generator]):
        self.model, self.optimizer, self.generators = model, optimizer, generators
        with torch.no_grad():
            self.weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
            self.state = {p: {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in optimizer.state[p].items()}
                          for g in optimizer.param_groups for p in g["params"]
                          if p in optimizer.state}
        self.rng = [g.get_state() for g in generators]

    @torch.no_grad()
    def restore(self) -> None:
        for k, v in self.model.state_dict().items():
            v.copy_(self.weights[k])
        for g in self.optimizer.param_groups:
            for p in g["params"]:
                saved = self.state.get(p)
                for k, v in self.optimizer.state.get(p, {}).items():
                    if torch.is_tensor(v):
                        v.copy_(saved[k]) if saved is not None else v.zero_()
        for g, s in zip(self.generators, self.rng):
            g.set_state(s)


class CapturedStep:
    """``step`` (a training step reading its inputs from static tensors)
    captured as one CUDA graph: :meth:`capture` once, then :meth:`replay`
    for each step. ``reset`` runs before each warm-up step (it points the
    step at valid inputs: the first row of the tables)."""

    def __init__(self, step: Callable[[], None], model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 generators: Sequence[torch.Generator] = (),
                 reset: Callable[[], None] = lambda: None,
                 warmup: int = WARMUP_STEPS):
        self.step, self.model, self.optimizer = step, model, optimizer
        self.generators = [g for g in generators if g is not None]
        self.reset, self.warmup = reset, warmup
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s: Optional[float] = None

    def capture(self) -> float:
        """Warm up, undo the warm-up, capture; returns the seconds it took."""
        t0 = time.perf_counter()
        snap = Snapshot(self.model, self.optimizer, self.generators)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                self.reset()
                self.step()
        torch.cuda.current_stream().wait_stream(side)
        snap.restore()
        self.reset()
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if self.generators and register is None:
            raise RuntimeError("this PyTorch cannot register a generator with a CUDA "
                               "graph (CUDAGraph.register_generator_state): the step's "
                               "draws cannot be captured; set setup.epoch_scan 'never'")
        for g in self.generators:
            register(g)
        # Thread-local: under several ranks NCCL's watchdog thread queries
        # the events of earlier collectives while this thread captures.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.step()
        # The capture ran nothing; the generators are put back all the same.
        snap.restore()
        torch.cuda.synchronize()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return self.capture_s

    def replay(self) -> None:
        self.graph.replay()

    def release(self) -> None:
        """Free the graph. One that captured NCCL collectives holds
        resources of their communicator, which is not destroyed while the
        graph lives: release it before the process group goes."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


class EpochProgram:
    """The trainer's training step over one epoch's tables, on the card a
    :class:`CapturedStep` (``capture``), else the body issued step by step
    (module docstring). Under several ranks every rank holds the whole
    tables and each step keeps its row's columns of this rank's share of
    the batch (``parallel/mesh.py::shard_batch``'s rows, the JAX package's
    ``P(None, "data")`` shard of the table); the batches come from the
    loader's device buffers or, where it assembles them on the host, from
    its ``host_buffers`` placed on this rank's device here."""

    def __init__(self, trainer, capture: bool):
        loader, mesh = trainer.train_loader, trainer.mesh
        why = epoch_path_reason(loader, mesh.world)
        if why:
            raise RuntimeError(f"the epoch path needs batches gathered on the device: {why}")
        self.trainer = trainer
        self.bufs, self.batch_fn = (loader.device_epoch_spec or device_spec(
            loader.host_buffers, loader.layout, trainer.device))
        dev = trainer.device
        k, b = len(loader), loader.batch_size
        self.share = (mesh.data_index * (b // mesh.dp), b // mesh.dp)
        self.idx = torch.zeros((k, b), dtype=torch.int64, device=dev)
        self.mask = torch.zeros((k, b), dtype=torch.bool, device=dev)
        self.lr = torch.zeros(k, dtype=torch.float64, device=dev)
        self.losses = torch.zeros(k, dtype=torch.float32, device=dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)
        ddp = trainer.train_model is not trainer.model
        self.captured = (CapturedStep(self._body, trainer.model, trainer.optimizer,
                                      [trainer.generator], reset=self.t.zero_,
                                      warmup=DDP_WARMUP_STEPS if ddp else WARMUP_STEPS)
                         if capture else None)

    def _body(self) -> None:
        """Step t of the epoch, t read on the device: its row of the
        tables (this rank's columns), its batch, the step body, its loss
        into slot t, t + 1."""
        t, (lo, n) = self.t, self.share
        row = lambda table: table.index_select(0, t).view(-1).narrow(0, lo, n)
        batch = self.batch_fn(self.bufs, row(self.idx))
        batch["sample_mask"] = row(self.mask)
        # A vx layout's row maps: this rank's samples' (whole on one rank).
        batch = shard_batch(batch, self.trainer.mesh, self.idx.shape[1])
        loss = self.trainer.step_body(batch, self.lr.index_select(0, t).view(()))
        self.losses.index_copy_(0, t, loss.float().view(1))
        # Past the last row the counter wraps to the first: a replay is
        # always a valid step.
        t.add_(1).remainder_(self.losses.shape[0])

    def _load(self, name: str, a: np.ndarray) -> None:
        src = torch.from_numpy(np.ascontiguousarray(a))
        dst = getattr(self, name)
        if dst.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def load(self, idx: np.ndarray, mask: np.ndarray, lr: np.ndarray) -> None:
        """Copy an epoch's tables in and point the counter at its first
        step; before the first epoch, capture (the warm-up steps read the
        tables)."""
        for name, a in (("idx", idx), ("mask", mask), ("lr", lr)):
            self._load(name, a)
        self.t.zero_()
        if self.captured is not None and self.captured.graph is None:
            self.captured.capture()

    def run(self, idx: np.ndarray, mask: np.ndarray, lr: np.ndarray) -> torch.Tensor:
        """One epoch: :meth:`load`, then the k steps. Returns the [k]
        losses on the device."""
        self.load(idx, mask, lr)
        for _ in range(self.losses.shape[0]):
            if self.captured is None:
                self._body()
            else:
                self.captured.replay()
        return self.losses.clone()


class RolloutProgram:
    """One predict mode's rollout (``models/rollout.py``) over the batches
    ``placed`` of one shape: with ``capture``, the first batch's rollout
    captured as one CUDA graph on static copies of its tensors, each batch
    copied in and the graph replayed; else the steps issued one by one.
    ``graph_args(placed)`` gives (graphs, coordinates) of a placed batch."""

    def __init__(self, model, time_indices, t_values, stats: Dict, stepper_mode: str,
                 graph_args: Callable[[Dict], tuple],
                 use_conditional_norm: bool = False, capture: bool = False):
        self.model, self.graph_args = model, graph_args
        self.use_conditional_norm = use_conditional_norm
        self.plan = (time_indices, t_values, stats, stepper_mode)
        self.consts = None       # placed at the first batch, in its dtype
        self.capture = capture
        self.static: Optional[Dict[str, torch.Tensor]] = None
        self.out: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    @torch.no_grad()
    def _rollout(self, placed: Dict) -> torch.Tensor:
        if self.consts is None:
            x = placed["input"]
            self.consts = rollout_constants(*self.plan, x.device, x.dtype)
        graphs, coord = self.graph_args(placed)
        return rollout_steps(self.model, placed["input"], self.consts, graphs, coord,
                             self.use_conditional_norm)

    @torch.no_grad()
    def __call__(self, placed: Dict) -> torch.Tensor:
        if not self.capture:
            return self._rollout(placed)
        tensors = {k: v for k, v in placed.items() if torch.is_tensor(v)}
        if self.graph is None:
            self.static = {k: v.clone() for k, v in tensors.items()}
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._rollout(self.static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self._rollout(self.static)
            self.graph = graph
        for k, v in tensors.items():
            self.static[k].copy_(v)
        self.graph.replay()
        return self.out.clone()
