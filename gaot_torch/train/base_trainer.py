"""Base trainer lifecycle.

Counterpart of ``gaot_tpu/train/base_trainer.py`` (reference
src/core/base_trainer.py:19-280): merge the configs, look up the metadata,
seed, then ``init_dataset``, ``init_model``, ``init_optimizer``; ``fit``
trains with validation every ``eval_every_eps`` epochs, keeps the best
weights, checkpoints them, writes the loss record and runs ``test``.

The trainer runs on the card unless ``setup.device`` is ``"cpu"``; with
``"auto"`` or ``"cuda"`` and no card it raises. Steps are issued one by one:
the JAX package's whole-epoch ``lax.scan`` and its compile cache are XLA
tactics with no counterpart here, whatever ``setup.epoch_scan`` says. Its
mesh (``parallel/*``) is ROADMAP item 13: ``distributed``,
``model_parallel > 1``, ``data_parallel > 1`` and ``spatial_parallel``
raise ``NotImplementedError``.
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


def _check_single_device(setup: SetUpConfig) -> None:
    if setup.distributed or setup.model_parallel > 1 or setup.spatial_parallel \
            or setup.data_parallel > 1:
        raise NotImplementedError(
            "multi-device training (distributed, data_parallel > 1, "
            "model_parallel > 1, spatial_parallel) is not ported: ROADMAP item 13")


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
        _check_single_device(self.setup_config)
        self.device = resolve_device(self.setup_config.device)
        np.random.seed(self.setup_config.seed)
        # The training steps' draws (edge drop, attention dropout), from the
        # seed on the model's device. As the JAX package's rng key, it is
        # not checkpointed: a resumed run draws from the seed again.
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.setup_config.seed)
        if self.setup_config.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"setup.compute_dtype {self.setup_config.compute_dtype!r} "
                             f"is not one of {sorted(_COMPUTE_DTYPES)}")
        self.compute_dtype = _COMPUTE_DTYPES[self.setup_config.compute_dtype]

        # Populated by subclasses.
        self.model: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.schedule = None
        self.step = 0                     # updates taken; the schedule reads it
        self.train_loader = None
        self.val_loader = None
        self.test_loader = None

        self.init_dataset(self.dataset_config)
        self.init_model(self.model_config)
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
        params = list(self.model.parameters())
        nparams = sum(p.numel() for p in params)
        nbytes = sum(p.numel() * p.element_size() for p in params)
        print(f"Number of parameters: {nparams}")
        self.datarow["nparams"] = nparams
        self.datarow["nbytes"] = nbytes

    def place_batch(self, batch: Dict) -> Dict:
        """The batch's arrays on the trainer's device (those already there
        are kept); ``sample_mask`` stays a NumPy array, the host's count of
        the real samples."""
        return {k: to_device(v, self.device)
                if isinstance(v, np.ndarray) and k != "sample_mask" else v
                for k, v in batch.items()}

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
                samples_done += int(np.sum(batch["sample_mask"]))
            if epoch == 0 and verbose:
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
                if verbose:
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
        if verbose:
            print(f"training time {elapsed:.1f}s "
                  f"({self.datarow['samples_per_sec']:.1f} samples/s)")

        self.save_ckpt()
        if losses:
            os.makedirs(os.path.dirname(self.path_config.loss_path) or ".",
                        exist_ok=True)
            plot_losses(self.path_config.loss_path, epochs, losses,
                        val_epochs, val_losses, best_epoch, best_loss)
        self.test()

    # ------------------------------------------------------------------
    def save_ckpt(self):
        save_checkpoint(self.path_config.ckpt_path, self.model, self.optimizer,
                        self.step)
        return self

    def load_ckpt(self):
        state = load_checkpoint(self.path_config.ckpt_path, self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = state["step"]
        return self
