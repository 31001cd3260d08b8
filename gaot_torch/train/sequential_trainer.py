"""Trainer for sequential (time-dependent) problems.

Counterpart of ``gaot_tpu/train/sequential_trainer.py`` (reference
src/trainer/sequential_trainer.py:20-588): it trains on time pairs
(``data/sequential.py``) and evaluates by autoregressive rollout
(``models/rollout.py``) in the 'autoregressive', 'direct' and 'star'
predict modes, with the 'final_step' or 'all_step' metric. fx and vx
alike: a vx trajectory keeps its mesh, so each sample's graphs are built
from its coordinates at t = 0.

It is the static trainer with other data, other inputs and another test:
the model, the graph arguments, the steps, the validation and the refusals
of what is not ported are the static trainer's.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.graph_builder import vx_layout
from ..data.loader import BatchLoader
from ..data.sequential import (
    DynamicPairBatcher,
    RolloutTestBatcher,
    SequentialDataProcessor,
    make_sequential_loader,
)
from ..models.rollout import autoregressive_predict
from ..utils.metrics import compute_batch_errors, compute_final_metric
from ..utils.plotting import create_sequential_animation, plot_estimates, pyplot
from .static_trainer import StaticTrainer

PREDICT_MODES = ("autoregressive", "direct", "star")


def predict_mode_indices(mode: str, max_time_diff: int,
                         time_step: int) -> np.ndarray:
    """Rollout time indices of a predict mode. The reference
    (sequential_trainer.py:380-387) hard-codes max_time_diff 14 and
    time_step 2: autoregressive arange(0, 15, 2), direct [0, 14], star
    [0, 4, 8, 12, 14]; as in the JAX package, shorter trajectories
    (max_time_diff < 14) take the same rule over their own steps."""
    t = max_time_diff
    if mode == "direct":
        return np.array([0, t])
    if mode == "star":
        idx = np.arange(0, t + 1, 2 * time_step)
        return idx if idx[-1] == t else np.append(idx, t)
    return np.arange(0, t + 1, time_step)           # autoregressive


class SequentialTrainer(StaticTrainer):
    """The sequential trainer, fx and vx."""

    def __init__(self, config, datarow: Optional[Dict] = None):
        self.splits: Optional[Dict] = None
        self.stats: Optional[Dict] = None
        self.t_values: Optional[np.ndarray] = None
        self.stepper_mode: Optional[str] = None
        self.vx_graphs: Optional[Dict] = None
        super().__init__(config, datarow)

    # ------------------------------------------------------------------
    def init_dataset(self, dataset_config):
        cfg = dataset_config
        self.data_processor = SequentialDataProcessor(cfg, self.metadata,
                                                      dtype=np.float32,
                                                      seed=self.setup_config.seed)
        splits, is_vx = self.data_processor.load_and_process_data()
        self.coord_mode = "vx" if is_vx else "fx"
        self.splits = splits
        self.stats = self.data_processor.stats
        self.t_values = self.data_processor.t_values
        self.stepper_mode = self.data_processor.stepper_mode

        latent = self.data_processor.generate_latent_queries(
            tuple(self.model_config.latent_tokens_size))
        self.latent = torch.from_numpy(latent).to(self.device)
        self.coord_dim = splits["train"]["x"].shape[-1]
        u, c = splits["train"]["u"], splits["train"]["c"]
        self.num_output_channels = u.shape[-1]
        # u, c, the start time and the time difference; a conditional-norm
        # model drops the time difference.
        self.num_input_channels = u.shape[-1] + 2 + (c.shape[-1] if c is not None else 0)
        if self.model_config.use_conditional_norm:
            self.num_input_channels -= 1

        if is_vx:
            self.vx_graphs = self._build_vx_graphs(
                {name: {"x": sp["x"][:, 0] if sp["x"].ndim == 4 else sp["x"]}
                 for name, sp in splits.items()}, latent, cache_suffix="-seq")
        else:
            self._build_fx_graphs(splits["train"]["x"], latent)

        loaders = {}
        for name in ["train", "val", "test"]:
            graphs = self.vx_graphs[name] if is_vx else None
            if is_vx and graphs is None:
                loaders[name] = None
                continue
            batcher = DynamicPairBatcher(
                splits[name]["u"], splits[name]["c"], splits[name]["t"],
                cfg.max_time_diff, cfg.time_step, cfg.stepper_mode, self.stats,
                use_time_norm=cfg.use_time_norm, graphs=graphs)
            loaders[name] = make_sequential_loader(
                batcher, cfg.batch_size, shuffle=(cfg.shuffle and name == "train"),
                seed=self.setup_config.seed, device_data=cfg.device_data,
                device=self.device)
        self.train_loader = loaders["train"]
        self.val_loader = loaders["val"]
        self.test_loader = loaders["test"]

    def _inputs(self, batch: Dict):
        """A conditional-norm model drops the last input channel (the time
        difference) and takes the start time as its condition (reference
        sequential_trainer.py:192-198)."""
        x = batch["input"]
        if self.model_config.use_conditional_norm:
            return x[..., :-1], batch["target"], x[:, 0, -2:-1]
        return x, batch["target"], None

    # ------------------------------------------------------------------
    def test(self):
        """Rollout evaluation in the configured predict modes (reference
        sequential_trainer.py:362-463)."""
        cfg = self.dataset_config
        modes = list(PREDICT_MODES) if cfg.predict_mode == "all" else [cfg.predict_mode]
        if cfg.metric not in ("final_step", "all_step"):
            raise ValueError(f"Unknown metric: {cfg.metric}")
        test = self.splits["test"]
        vx = self.coord_mode == "vx"
        graphs = self.vx_graphs["test"] if vx else None
        self.model.eval()
        errors, example = {}, None
        for mode in modes:
            t_lim = min(cfg.max_time_diff, test["u"].shape[1] - 1)
            time_indices = predict_mode_indices(mode, t_lim, cfg.time_step)
            batcher = RolloutTestBatcher(test["u"], test["c"], time_indices,
                                         self.stats, graphs=graphs)
            layout = vx_layout(batcher.buffers, min(cfg.batch_size, len(batcher))) \
                if vx else {}
            loader = BatchLoader(len(batcher), cfg.batch_size,
                                 lambda idx: {**batcher.get_batch(idx), **layout})
            all_errs = []
            for batch in loader:
                # The target stays on the host, where the metric is taken.
                placed = self.place_batch({k: v for k, v in batch.items()
                                           if k != "target"})
                graph_args, coord, _ = self._model_args(placed)
                pred = autoregressive_predict(
                    self.model, placed["input"], time_indices, self.t_values,
                    self.stats, self.stepper_mode, graph_args, coord,
                    use_conditional_norm=self.model_config.use_conditional_norm)
                # Each rank rolls its share out; the metric takes the batch.
                keep = batch["sample_mask"]
                pred = self.gather_batch(pred, len(keep)).cpu().numpy()
                target = np.asarray(batch["target"], dtype=np.float64)
                pred, target = pred[keep], target[keep]
                if vx:
                    # Padded nodes take the metric's global mean on both
                    # sides: they add nothing to the relative L1.
                    active = list(self.metadata.active_variables)
                    gmean = np.asarray(self.metadata.global_mean)[active]
                    valid = batch["node_mask"][keep][:, None, :, None]
                    pred = np.where(valid, pred, gmean)
                    target = np.where(valid, target, gmean)
                if cfg.metric == "final_step":
                    errs = compute_batch_errors(target[:, -1:], pred[:, -1:],
                                                self.metadata)
                else:
                    errs = compute_batch_errors(target, pred, self.metadata)
                all_errs.append(errs)
                if example is None:
                    coords = batch["x"][keep][-1] if vx else self.coord.cpu().numpy()
                    example = {
                        "input": batch["input"][keep][-1],
                        "gt_sequence": target[-1],
                        "pred_sequence": pred[-1],
                        "time_indices": time_indices,
                        "coords": self.data_processor.coord_scaler.inverse_transform(coords),
                    }
            errors[mode] = compute_final_metric(np.concatenate(all_errs, 0))
            if self.rank0:
                print(f"{mode} mode error: {errors[mode]}")

        self._store_results(errors, modes)
        if example is not None and self.rank0:
            self._plot_results(example)
        return errors

    def _store_results(self, errors, modes):
        """The CSV datarow's keys are the reference's
        (sequential_trainer.py:496-504)."""
        if len(modes) > 1:
            self.datarow["relative error (direct)"] = errors.get("direct", 0.0)
            self.datarow["relative error (auto2)"] = errors.get("autoregressive", 0.0)
            self.datarow["relative error (auto4)"] = errors.get("star", 0.0)
        else:
            self.datarow[f"relative error ({modes[0]})"] = errors[modes[0]]

    def _plot_results(self, example):
        """The last step's result plot and, on 2D coordinates, the rollout's
        animation (a GIF beside it). Without matplotlib (or, for the GIF,
        Pillow) nothing is drawn; a plot never fails a run."""
        if pyplot() is None:
            print("matplotlib is not installed: no result plot or animation")
            return
        try:
            u_stats = self.stats["u"]
            u_dim = len(np.asarray(u_stats["mean"]))
            inp = example["input"][..., :u_dim] * u_stats["std"] + u_stats["mean"]
            fig = plot_estimates(
                u_inp=inp,
                u_gtr=example["gt_sequence"][-1],
                u_prd=example["pred_sequence"][-1],
                x_inp=example["coords"],
                names=self.metadata.names["u"],
                symmetric=self.metadata.signed["u"],
                domain=self.metadata.domain_x,
            )
            os.makedirs(os.path.dirname(self.path_config.result_path) or ".",
                        exist_ok=True)
            fig.savefig(self.path_config.result_path, dpi=200,
                        bbox_inches="tight", pad_inches=0.1)
            pyplot().close(fig)
            if self.coord_dim == 2:
                gif_path = self.path_config.result_path.replace(".png", ".gif")
                if create_sequential_animation(
                        gt_sequence=example["gt_sequence"],
                        pred_sequence=example["pred_sequence"],
                        coords=example["coords"], save_path=gif_path,
                        time_values=[self.t_values[i]
                                     for i in example["time_indices"][1:]],
                        symmetric=self.metadata.signed.get("u"),
                        names=self.metadata.names.get("u")):
                    print(f"Animation saved to {gif_path}")
        except Exception as e:  # plotting must never fail a run
            print(f"Warning: could not create sequential plots: {e}")
