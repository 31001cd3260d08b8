"""Base trainer lifecycle.

Counterpart of ``gaot_tpu/train/base_trainer.py`` (reference
src/core/base_trainer.py:19-280): merge the configs, look up the metadata,
seed, then ``init_dataset``, ``init_model``, ``init_optimizer``; ``fit``
trains with validation every ``eval_every_eps`` epochs, keeps the best
weights, checkpoints them, writes the loss record and runs ``test``.

The trainer runs on the card unless ``setup.device`` is ``"cpu"``; with
``"auto"`` or ``"cuda"`` and no card it raises. Steps are issued one by one:
the JAX package's whole-epoch ``lax.scan`` and its compile cache are XLA
tactics with no counterpart here, whatever ``setup.epoch_scan`` says.

Several ranks (``setup.distributed``, launched by torchrun) form a dp × mp
mesh (``parallel/mesh.py``): each rank takes its share of every global
batch (all ranks see the same sample order), the model is wrapped in
``DistributedDataParallel`` over the data axis, the UViT is split over the
model axis (``model_parallel``) or, under ``spatial_parallel``, the
queries are (``parallel/spatial.py``). The loss is the global masked mean,
validation and test metrics are summed over the ranks, so they equal one
process's; rank 0 alone prints and writes.
"""
from __future__ import annotations

import os
import time
from abc import ABC, abstractmethod
from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import (
    DatasetConfig,
    GAOTConfig,
    ModelConfig,
    OptimizerConfig,
    PathConfig,
    SetUpConfig,
    merge_config,
)
from ..core.metadata import DATASET_METADATA
from ..data.loader import PrefetchLoader, to_device
from ..parallel import comm
from ..parallel.mesh import (
    full_optimizer_state,
    full_state_dict,
    init_distributed,
    load_full_optimizer_state,
    load_full_state,
    make_mesh,
    optimizer_specs,
    shard_batch,
    shard_model,
)
from ..parallel.spatial import gather_nodes
from ..utils.plotting import plot_losses
from ..utils.routing import format_routes
from ..utils.timing import force_value
from .checkpoint import load_checkpoint, save_checkpoint
from .schedules import make_optimizer

# Compute dtypes the model takes (None: fp32); parameters stay fp32.
_COMPUTE_DTYPES = {
    "float32": None, "torch.float32": None, "float": None,
    "bfloat16": torch.bfloat16, "torch.bfloat16": torch.bfloat16,
}


def resolve_device(name: str) -> torch.device:
    """``setup.device``: "auto" and "cuda" mean the card and raise where
    there is none; only "cpu" runs on the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("auto", "cuda"):
        raise ValueError(f"setup.device must be auto/cuda/cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"setup.device {name!r} needs a CUDA device and "
                           "torch.cuda.is_available() is false; set it to "
                           "'cpu' to train on the CPU")
    return torch.device("cuda")


class BaseTrainer(ABC):
    """Common lifecycle: merge configs → data → model → optimizer → fit/test."""

    def __init__(self, config, datarow: Optional[Dict] = None):
        if isinstance(config, GAOTConfig):
            self.setup_config = config.setup
            self.model_config = config.model
            self.dataset_config = config.dataset
            self.optimizer_config = config.optimizer
            self.path_config = config.path
        else:
            raw = dict(config)
            self.setup_config = merge_config(SetUpConfig, raw.get("setup", {}))
            self.model_config = merge_config(ModelConfig, raw.get("model", {}))
            self.dataset_config = merge_config(DatasetConfig, raw.get("dataset", {}))
            self.optimizer_config = merge_config(OptimizerConfig, raw.get("optimizer", {}))
            self.path_config = merge_config(PathConfig, raw.get("path", {}))

        self.metadata = DATASET_METADATA[self.dataset_config.metaname]
        self.datarow = datarow if datarow is not None else {}
        setup = self.setup_config
        init_distributed(setup)
        self.mesh = make_mesh(setup.data_parallel, setup.model_parallel,
                              setup.spatial_parallel)
        self.rank0 = self.mesh.rank == 0
        self.device = resolve_device(setup.device)
        # As in the JAX package, only the legacy NumPy seed differs by rank:
        # the weights, the sample order and the step's draws must be one
        # process's on every rank.
        np.random.seed(setup.seed + self.mesh.rank)
        # The training steps' draws (edge drop, attention dropout), from the
        # seed on the model's device, the same on every rank (a rank keeps
        # its share of the global batch's draws). As the JAX package's rng
        # key, it is not checkpointed: a resumed run draws from the seed again.
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.setup_config.seed)
        if self.setup_config.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"setup.compute_dtype {self.setup_config.compute_dtype!r} "
                             f"is not one of {sorted(_COMPUTE_DTYPES)}")
        self.compute_dtype = _COMPUTE_DTYPES[self.setup_config.compute_dtype]

        # Populated by subclasses.
        self.spatial = None     # this rank's query ranges (spatial_parallel)
        self.model: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.schedule = None
        self.step = 0                     # updates taken; the schedule reads it
        self.train_loader = None
        self.val_loader = None
        self.test_loader = None

        self.init_dataset(self.dataset_config)
        loader = self.train_loader or self.test_loader
        if loader is not None and loader.batch_size % self.mesh.dp:
            raise ValueError(f"batch_size {loader.batch_size} not divisible by "
                             f"data_parallel {self.mesh.dp}")
        self.init_model(self.model_config)
        if self.spatial is not None:
            self.model.shard_queries(self.spatial)
        # The UViT's weights split over the model axis (name → dim; {}
        # without tensor parallelism), then DDP over the data axis.
        self.tp_specs = shard_model(self.model, self.mesh)
        self.train_model = self.model
        if self.mesh.dp > 1:
            import warnings

            from torch.nn.parallel import DistributedDataParallel

            # The buffers (the absolute positions) are constants: no
            # broadcast a step (newer PyTorch renames the switch).
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                self.train_model = DistributedDataParallel(
                    self.model, process_group=self.mesh.data_group,
                    broadcast_buffers=False, static_graph=True)
        self.init_optimizer(self.optimizer_config)
        self._print_model_stats()

    # ------------------------------------------------------------------
    @abstractmethod
    def init_dataset(self, dataset_config):
        ...

    @abstractmethod
    def init_model(self, model_config):
        ...

    def init_optimizer(self, optimizer_config):
        steps_per_epoch = max(1, len(self.train_loader) if self.train_loader else 1)
        self.optimizer, self.schedule = make_optimizer(
            optimizer_config, self.model.parameters(), steps_per_epoch)

    @abstractmethod
    def train_step(self, batch) -> torch.Tensor:
        """One optimization step; returns the (device) loss scalar."""

    @abstractmethod
    def validate(self, loader) -> float:
        ...

    @abstractmethod
    def test(self):
        ...

    # ------------------------------------------------------------------
    def _print_model_stats(self):
        """The full model's parameter count (a split weight counts whole)."""
        nparams = nbytes = 0
        for name, p in self.model.named_parameters():
            n = p.numel() * (self.mesh.mp if name in self.tp_specs else 1)
            nparams += n
            nbytes += n * p.element_size()
        if self.rank0:
            print(f"Number of parameters: {nparams}")
        self.datarow["nparams"] = nparams
        self.datarow["nbytes"] = nbytes

    def place_batch(self, batch: Dict) -> Dict:
        """This rank's share of the batch (``parallel/mesh.py::shard_batch``),
        its arrays on the trainer's device (those already there are kept);
        ``sample_mask`` stays a NumPy array, the host's count of the real
        samples, and ``global_samples`` counts the global batch's. A batch
        without a sample mask is placed whole (one rank on the data axis)."""
        mask = batch.get("sample_mask")
        if mask is not None:
            batch = shard_batch(batch, self.mesh, len(mask))
        elif self.mesh.dp > 1:
            raise ValueError("a batch is shared over the data axis by its sample_mask")
        out = {k: to_device(v, self.device)
               if isinstance(v, np.ndarray) and k != "sample_mask" else v
               for k, v in batch.items()}
        if mask is not None:
            out["global_samples"] = int(np.sum(mask))
        return out

    def gather_batch(self, t: torch.Tensor, batch_size: int,
                     node_dim: Optional[int] = None) -> torch.Tensor:
        """The global batch's rows of a per-rank result ``t`` (each rank's
        share of the leading axis, in rank order; the padding of a batch
        that dp does not divide cut off), and under spatial parallelism all
        the output queries of axis ``node_dim``."""
        if node_dim is not None:
            t = gather_nodes(t, self.spatial, node_dim)
        return comm.all_gather(t, self.mesh.data_group, 0)[:batch_size]

    def local_nodes(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's output queries of a target [B, N, C] (all of them
        without spatial parallelism)."""
        if self.spatial is None:
            return t
        return t[:, self.spatial.nodes[0]:self.spatial.nodes[1]]

    def sample_mask(self, batch: Dict) -> torch.Tensor:
        return to_device(batch["sample_mask"], self.device)

    # ------------------------------------------------------------------
    def fit(self, verbose: bool = True):
        """Training loop: steps issued one by one, validation every
        ``eval_every_eps`` epochs, best weights kept, then checkpoint, loss
        record and test (reference base_trainer.py:196-225 +
        optimizers.py:236-305)."""
        args = self.optimizer_config.args
        eval_every = args.eval_every_eps
        early_metric = args.early_save_metric.lower()
        best_loss, best_epoch, best_state = np.inf, -1, None
        losses, epochs, val_losses, val_epochs = [], [], [], []

        # Batch assembly (and, on the host path, the copy to the device)
        # runs on a worker thread, beside the step that consumes the last
        # batch.
        train_iter = PrefetchLoader(self.train_loader, place_fn=self.place_batch)
        start = time.perf_counter()
        samples_done = 0
        for epoch in range(args.epoch):
            # Step losses stay on the device until an evaluation reads them.
            epoch_losses = []
            for batch in train_iter:
                epoch_losses.append(self.train_step(batch))
                samples_done += batch["global_samples"]
            if epoch == 0 and verbose and self.rank0:
                # The dispatch sites record their routes as they run, so
                # after the first epoch the route set is known.
                print(f"[gaot_torch] kernel routes: {format_routes()} "
                      f"steps=per-step (setup.epoch_scan has no counterpart)",
                      flush=True)
            if (epoch + 1) % eval_every == 0:
                train_loss = float(torch.stack(epoch_losses).mean())
                val_loss = self.validate(self.val_loader)
                losses.append(train_loss)
                epochs.append(epoch)
                val_losses.append(val_loss)
                val_epochs.append(epoch)
                current = val_loss if early_metric == "val" else train_loss
                if current < best_loss:
                    best_loss, best_epoch = current, epoch
                    # Clones: the optimizer updates the live tensors in place.
                    best_state = {k: v.detach().clone()
                                  for k, v in self.model.state_dict().items()}
                if verbose and self.rank0:
                    # The losses were read, so the device has run every step
                    # so far: the clock counts them.
                    print(f"epoch {epoch + 1}/{args.epoch} "
                          f"loss {train_loss:.3e} val {val_loss:.3e} "
                          f"at {time.perf_counter() - start:.3f} s")
        # The device's queued steps count in the training time.
        force_value(next(self.model.parameters()))
        elapsed = time.perf_counter() - start

        # As in the JAX package, the best weights come back; the optimizer
        # state and the update count stay those of the last step.
        if best_state is not None:
            self.model.load_state_dict(best_state)
        self.datarow["training time"] = elapsed
        self.datarow["samples_per_sec"] = samples_done / elapsed if elapsed else 0.0
        if verbose and self.rank0:
            print(f"training time {elapsed:.1f}s "
                  f"({self.datarow['samples_per_sec']:.1f} samples/s)")

        self.save_ckpt()
        if losses and self.rank0:
            os.makedirs(os.path.dirname(self.path_config.loss_path) or ".",
                        exist_ok=True)
            plot_losses(self.path_config.loss_path, epochs, losses,
                        val_epochs, val_losses, best_epoch, best_loss)
        self.test()

    # ------------------------------------------------------------------
    def full_state(self) -> Dict[str, torch.Tensor]:
        """The model's full ``state_dict``, its split weights joined (every
        rank of the model axis calls it)."""
        return full_state_dict(self.model.state_dict(), self.tp_specs, self.mesh)

    def load_full_weights(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a full ``state_dict`` strictly, each rank its shards."""
        self.model.load_state_dict(load_full_state(state, self.tp_specs, self.mesh))

    def save_ckpt(self):
        """Rank 0 writes the full weights and optimizer state (joined over
        the model axis), so a checkpoint of any mesh loads into any other."""
        ids = optimizer_specs(self.model, self.tp_specs)
        model = self.full_state()
        optim = full_optimizer_state(self.optimizer.state_dict(), ids, self.mesh)
        if self.rank0:
            save_checkpoint(self.path_config.ckpt_path, model, optim, self.step)
        if self.mesh.world > 1:
            torch.distributed.barrier()
        return self

    def load_ckpt(self):
        state = load_checkpoint(self.path_config.ckpt_path, self.device)
        self.load_full_weights(state["model"])
        self.optimizer.load_state_dict(load_full_optimizer_state(
            state["optimizer"], optimizer_specs(self.model, self.tp_specs), self.mesh))
        self.step = state["step"]
        return self
