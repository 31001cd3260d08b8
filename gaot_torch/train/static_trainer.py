"""Trainer for static (time-independent) problems.

Counterpart of ``gaot_tpu/train/static_trainer.py``: ``masked_mse``, the
training and evaluation steps (its jitted ``train_fn`` and ``eval_fn``) and
the :class:`StaticTrainer`, in both coordinate modes:

- fx: every batch shares one point cloud and one graph pair per scale;
- vx (a mesh per sample): each batch carries its samples' coordinates,
  node mask and stacked graphs, built once per split on the host
  (``data/graph_builder.py``) and selected with the samples by the loader;
  the loss and the metric count real nodes only.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..data.data_processor import DataProcessor
from ..data.graph_builder import GraphBuilder, prepare_fx_device_graphs, vx_flat_graphs
from ..data.loader import make_static_fx_loader, make_static_vx_loader
from ..models import GAOT
from ..utils.metrics import compute_batch_errors, compute_final_metric
from ..utils.plotting import plot_estimates, pyplot
from .base_trainer import BaseTrainer


class FxGraphs(NamedTuple):
    """The model's graph arguments, all on the model's device: in fx the
    split's shared graphs, in vx one batch's stacked per-sample graphs."""

    latent_tokens_coord: torch.Tensor
    encoder: list
    decoder: list
    encoder_t: Optional[list] = None
    decoder_t: Optional[list] = None


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               sample_mask: torch.Tensor,
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE over valid (sample, node) entries, in fp32."""
    err = (pred.float() - target.float()) ** 2
    w = sample_mask.float()[:, None, None]
    if node_mask is not None:
        w = w * node_mask.float()[..., None]
    w = w.expand(err.shape)
    return (err * w).sum() / w.sum().clamp(min=1.0)


def _forward(model, graphs: FxGraphs, coord, pndata):
    return model(graphs.latent_tokens_coord, coord, pndata, graphs.encoder,
                 graphs.decoder, encoder_tgraphs=graphs.encoder_t,
                 decoder_tgraphs=graphs.decoder_t)


def train_step(model, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], step: int, graphs: FxGraphs,
               coord: torch.Tensor, pndata: torch.Tensor, target: torch.Tensor,
               sample_mask: torch.Tensor,
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One optimizer step on one batch: the forward in training mode, the
    masked MSE, its backward through the kernels' gradients, then the
    update with the learning rate ``schedule(step)`` (``step`` counts the
    updates from 0). Returns the loss (detached, fp32)."""
    if model.processor.config.attn_config.atten_dropout > 0:
        raise NotImplementedError("attention dropout is not ported")
    if model.encoder.config.sampling_strategy is not None:
        raise NotImplementedError("edge drop (sampling_strategy) is not ported")
    if not model.encoder.config.use_transpose_backward:
        raise NotImplementedError("training needs the transpose graphs "
                                  "(magno.use_transpose_backward)")
    model.train()
    loss = masked_mse(_forward(model, graphs, coord, pndata), target,
                      sample_mask, node_mask)
    loss.backward()
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


@torch.no_grad()
def eval_step(model, graphs: FxGraphs, coord: torch.Tensor, pndata: torch.Tensor,
              target: torch.Tensor, sample_mask: torch.Tensor,
              node_mask: Optional[torch.Tensor] = None):
    """One evaluation batch: (prediction [B, N, Cout], masked MSE)."""
    pred = _forward(model, graphs, coord, pndata)
    return pred, masked_mse(pred, target, sample_mask, node_mask)


class StaticTrainer(BaseTrainer):
    """The static trainer, fx and vx (reference
    src/trainer/static_trainer.py:16-366)."""

    def __init__(self, config, datarow: Optional[Dict] = None):
        self.data_processor: Optional[DataProcessor] = None
        self.coord_dim: Optional[int] = None
        self.coord_mode: Optional[str] = None
        self.coord: Optional[torch.Tensor] = None    # fx: [N, d] model coordinates
        self.graphs: Optional[FxGraphs] = None       # fx: the shared graphs
        self.latent: Optional[torch.Tensor] = None   # [Q, d] latent grid
        super().__init__(config, datarow)

    # ------------------------------------------------------------------
    def init_dataset(self, dataset_config):
        self.data_processor = DataProcessor(dataset_config, self.metadata,
                                            dtype=np.float32,
                                            seed=self.setup_config.seed)
        splits, is_vx = self.data_processor.load_and_process_data()
        self.coord_mode = "vx" if is_vx else "fx"
        self._refuse_unported(dataset_config)

        # The latent grid fits the coordinate scaler (over the metadata
        # domain) before the nodes are scaled.
        latent = self.data_processor.generate_latent_queries(
            tuple(self.model_config.latent_tokens_size))
        self.latent = torch.from_numpy(latent).to(self.device)
        self.coord_dim = splits["train"]["x"].shape[-1]
        c_sample = splits["train"]["c"]
        if c_sample is None:
            raise ValueError(
                "Static training requires condition features 'c' as model input")
        self.num_input_channels = c_sample.shape[-1]
        self.num_output_channels = splits["train"]["u"].shape[-1]

        magno = self.model_config.args.magno
        builder = GraphBuilder.from_magno_config(magno)
        cfg = dataset_config
        if is_vx:
            graphs = builder.build_all_vx_graphs(
                splits, latent, magno.radius, magno.scales,
                build_train=self.setup_config.train,
                model_transform=self.data_processor.coord_scaler,
                with_transpose=magno.use_transpose_backward,
                bucketing=magno.use_query_bucketing)
            loaders = {
                name: None if graphs[name] is None else make_static_vx_loader(
                    splits[name]["c"], splits[name]["u"], graphs[name],
                    cfg.batch_size, shuffle=(cfg.shuffle and name == "train"),
                    seed=self.setup_config.seed, device_data=cfg.device_data,
                    device=self.device)
                for name in ["train", "val", "test"]
            }
        else:
            coord = self.data_processor.coord_scaler(splits["train"]["x"])
            enc, dec = builder.build_fx_graphs(coord, latent, magno.radius,
                                               magno.scales)
            self.coord = torch.from_numpy(coord.astype(np.float32)).to(self.device)
            self.graphs = FxGraphs(self.latent, *prepare_fx_device_graphs(
                enc, dec, coord.shape[0], latent.shape[0], magno,
                device=self.device))
            loaders = {
                name: make_static_fx_loader(
                    splits[name]["c"], splits[name]["u"], cfg.batch_size,
                    shuffle=(cfg.shuffle and name == "train"),
                    seed=self.setup_config.seed, device_data=cfg.device_data,
                    device=self.device)
                for name in ["train", "val", "test"]
            }
        self.train_loader = loaders["train"]
        self.val_loader = loaders["val"]
        self.test_loader = loaders["test"]

    def _refuse_unported(self, dataset_config):
        """Refuse, before any graph is built, what the port does not run."""
        magno = self.model_config.args.magno
        if self.setup_config.train and not magno.use_transpose_backward:
            raise NotImplementedError("training needs the transpose graphs "
                                      "(magno.use_transpose_backward)")
        if self.coord_mode != "vx":
            return
        if magno.transform_type != "linear" or magno.node_embedding:
            raise NotImplementedError(
                f"vx batches run the linear transform without node_embedding; "
                f"transform_type {magno.transform_type!r}, node_embedding "
                f"{magno.node_embedding} is not ported on vx (ROADMAP §1)")
        if dataset_config.graph_cache_dir:
            raise NotImplementedError("dataset.graph_cache_dir (the vx graph "
                                      "cache) is not ported (ROADMAP §1)")

    def init_model(self, model_config):
        model_config.args.magno.coord_dim = self.coord_dim
        self.model = GAOT(self.num_input_channels, self.num_output_channels,
                          model_config, dtype=self.compute_dtype,
                          device=self.device,
                          generator=torch.Generator().manual_seed(
                              self.setup_config.seed))

    # ------------------------------------------------------------------
    def _batch_graphs(self, batch: Dict) -> FxGraphs:
        """A vx batch's per-scale graphs, flattened over the batch, from its
        buffers and its layout."""
        return FxGraphs(self.latent, *vx_flat_graphs(
            batch, len(self.model_config.args.magno.scales)))

    def _model_args(self, batch: Dict):
        """(graphs, coordinates, node mask or None) of a placed batch."""
        if self.coord_mode == "fx":
            return self.graphs, self.coord, None
        return self._batch_graphs(batch), batch["x"], batch["node_mask"]

    def train_step(self, batch) -> torch.Tensor:
        batch = self.place_batch(batch)
        graphs, coord, node_mask = self._model_args(batch)
        loss = train_step(self.model, self.optimizer, self.schedule, self.step,
                          graphs, coord, batch["c"], batch["u"],
                          self.sample_mask(batch), node_mask)
        self.step += 1
        return loss

    def _eval(self, batch):
        """(prediction, masked MSE) of one batch, in evaluation mode."""
        self.model.eval()
        batch = self.place_batch(batch)
        graphs, coord, node_mask = self._model_args(batch)
        return eval_step(self.model, graphs, coord, batch["c"], batch["u"],
                         self.sample_mask(batch), node_mask)

    def validate(self, loader) -> float:
        if loader is None:
            return 0.0
        # Batch losses stay on the device; one read at the end.
        losses = [self._eval(batch)[1] for batch in loader]
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    def test(self):
        """Relative-L1 metric over the test split + result plot
        (reference static_trainer.py:267-320)."""
        dp = self.data_processor
        u_mean, u_std = dp.u_mean, dp.u_std
        all_errors = []
        last = None
        for batch in self.test_loader:
            pred, _ = self._eval(batch)
            pred = pred.float().cpu().numpy().astype(np.float64)
            target = np.asarray(torch.as_tensor(batch["u"]).cpu(), dtype=np.float64)
            keep = batch["sample_mask"]
            pred_denorm = pred[keep] * u_std + u_mean
            target_denorm = target[keep] * u_std + u_mean
            if self.coord_mode == "vx":
                # Padded nodes add nothing to the error nor to the |gt|
                # denominator of the relative L1: both sides take the
                # metric's global mean there.
                active = list(self.metadata.active_variables)
                gmean = np.asarray(self.metadata.global_mean)[active].reshape(1, 1, -1)
                valid = np.asarray(torch.as_tensor(batch["node_mask"]).cpu())[keep][..., None]
                pred_denorm = np.where(valid, pred_denorm, gmean)
                target_denorm = np.where(valid, target_denorm, gmean)
            # The reference hands 3-D [B, N, V] tensors to
            # compute_batch_errors, whose [1, 1, 1, -1] statistics broadcast
            # them to [1, B, N, V]: each test batch pools into one rel-L1
            # scalar (the batch folded into the "time" axis), and the median
            # is taken over batches. Kept as the JAX package keeps it.
            errs = compute_batch_errors(target_denorm[None], pred_denorm[None],
                                        self.metadata)
            all_errors.append(errs)
            # The example plot takes the last KEPT sample (the final batch is
            # padded with wrap-around samples whose mask is False).
            last = (batch, pred_denorm, target_denorm,
                    int(np.flatnonzero(keep)[-1]))
        self.last_test_errors = np.concatenate(all_errors, axis=0)
        final_metric = compute_final_metric(self.last_test_errors)
        self.datarow["relative error (direct)"] = final_metric
        print(f"Relative error: {final_metric}")
        self._plot_test_example(last)
        return final_metric

    def _plot_test_example(self, last):
        if last is None:
            return
        if pyplot() is None:
            print("matplotlib is not installed: no result plot")
            return
        batch, pred_denorm, target_denorm, bidx = last
        dp = self.data_processor
        try:
            coords = dp.coord_scaler.inverse_transform(
                (self.coord if self.coord_mode == "fx"
                 else torch.as_tensor(batch["x"][bidx])).cpu().numpy())
            c = batch.get("c")
            if c is not None and dp.c_mean is not None:
                c_denorm = np.asarray(torch.as_tensor(c[bidx]).cpu()) * dp.c_std + dp.c_mean
            else:
                c_denorm = None
            fig = plot_estimates(
                u_inp=c_denorm,
                u_gtr=target_denorm[-1],
                u_prd=pred_denorm[-1],
                x_inp=coords,
                names=self.metadata.names.get("c"),
                symmetric=self.metadata.signed["u"],
                domain=self.metadata.domain_x,
            )
            os.makedirs(os.path.dirname(self.path_config.result_path) or ".",
                        exist_ok=True)
            fig.savefig(self.path_config.result_path, dpi=200,
                        bbox_inches="tight", pad_inches=0.1)
            pyplot().close(fig)
            print(f"Plot saved to {self.path_config.result_path}")
        except Exception as e:  # plotting must never fail a run
            print(f"Warning: could not create result plot: {e}")
