"""Trainer for static (time-independent) problems.

Counterpart of ``gaot_tpu/train/static_trainer.py``: ``masked_mse``, the
training and evaluation steps (its jitted ``train_fn`` and ``eval_fn``) and
the :class:`StaticTrainer`, in both coordinate modes:

- fx: every batch shares one point cloud and one graph pair per scale;
- vx (a mesh per sample): each batch carries its samples' coordinates,
  node mask and stacked graphs, built once per split on the host
  (``data/graph_builder.py``) and selected with the samples by the loader;
  the loss and the metric count real nodes only.

Under ``spatial_parallel`` a rank's graphs hold its rows (fx: its latent
queries and nodes; vx: its share of each sample's padded nodes), its loss
and metric reading its nodes of the target and node mask.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..data.data_processor import DataProcessor
from ..data.graph_builder import (
    GraphBuilder,
    VxCounts,
    fx_draw_widths,
    prepare_fx_device_graphs,
    vx_flat_graphs,
    vx_node_pad,
)
from ..data.loader import make_static_fx_loader, make_static_vx_loader
from ..models import GAOT
from ..ops.draws import BatchShare
from ..parallel import comm
from ..parallel.spatial import cut_rows, spatial_shard, sum_grads
from ..utils.metrics import compute_batch_errors, compute_final_metric
from ..utils.plotting import plot_estimates, pyplot
from .base_trainer import BaseTrainer
from .schedules import set_lr


class FxGraphs(NamedTuple):
    """The model's graph arguments, all on the model's device: in fx the
    split's shared graphs, in vx one batch's stacked per-sample graphs."""

    latent_tokens_coord: torch.Tensor
    encoder: list
    decoder: list
    encoder_t: Optional[list] = None
    decoder_t: Optional[list] = None


def masked_sum_count(pred: torch.Tensor, target: torch.Tensor,
                     sample_mask: torch.Tensor,
                     node_mask: Optional[torch.Tensor] = None):
    """(Σ squared error, count) over valid (sample, node) entries, fp32."""
    err = (pred.float() - target.float()) ** 2
    w = sample_mask.float()[:, None, None]
    if node_mask is not None:
        w = w * node_mask.float()[..., None]
    w = w.expand(err.shape)
    return (err * w).sum(), w.sum()


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               sample_mask: torch.Tensor,
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE over valid (sample, node) entries, in fp32."""
    total, count = masked_sum_count(pred, target, sample_mask, node_mask)
    return total / count.clamp(min=1.0)


def global_masked_mse(pred, target, sample_mask, node_mask=None, mesh=None):
    """The masked MSE of the global batch from this rank's share: (the
    objective whose gradient, averaged by DDP over the data axis, is the
    one-process gradient, the loss). The sum over the global batch divided
    by its count of valid entries: each rank's objective is
    dp · local sum / global count, the count summed outside autograd (a
    mean of the ranks' means is wrong wherever their counts differ: vx node
    masks, a padded last batch). With no mesh of several ranks, the masked
    MSE twice."""
    if mesh is None or mesh.trivial:
        loss = masked_mse(pred, target, sample_mask, node_mask)
        return loss, loss.detach()
    total, count = masked_sum_count(pred, target, sample_mask, node_mask)
    count = comm.all_reduce(count.detach(), mesh.loss_group).clamp(min=1.0)
    loss = comm.all_reduce(total.detach(), mesh.loss_group) / count
    return total * mesh.dp / count, loss


def _forward(model, graphs: FxGraphs, coord, pndata, condition=None, generator=None):
    return model(graphs.latent_tokens_coord, coord, pndata, graphs.encoder,
                 graphs.decoder, encoder_tgraphs=graphs.encoder_t,
                 decoder_tgraphs=graphs.decoder_t, condition=condition,
                 generator=generator)


def train_step(model, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], step: int, graphs: FxGraphs,
               coord: torch.Tensor, pndata: torch.Tensor, target: torch.Tensor,
               sample_mask: torch.Tensor,
               node_mask: Optional[torch.Tensor] = None,
               condition: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               mesh=None) -> torch.Tensor:
    """One optimizer step on one batch with the learning rate
    ``schedule(step)`` (``step`` counts the updates from 0):
    :func:`step_update` at that rate."""
    return step_update(model, optimizer, schedule(step), graphs, coord, pndata,
                       target, sample_mask, node_mask, condition, generator, mesh)


def step_update(model, optimizer: torch.optim.Optimizer, lr, graphs: FxGraphs,
                coord: torch.Tensor, pndata: torch.Tensor, target: torch.Tensor,
                sample_mask: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mesh=None) -> torch.Tensor:
    """The training step's body, which the per-step path and the epoch path
    (``train/graphed.py``, captured as a CUDA graph on the card) both run,
    as the JAX trainers' ``_step_update`` serves their per-step jit and
    their epoch scan: the forward in training mode, the masked MSE, its
    backward through the kernels' gradients, then the update at the
    learning rate ``lr`` (a float, or a 0-dimensional device tensor read
    from the epoch's table; :func:`~gaot_torch.train.schedules.set_lr`).
    Nothing in it waits for the device or copies from the host.
    ``condition`` [B, 1] is the time condition of a conditional-norm
    model. ``generator`` (on the model's device) draws the edge drop and
    the attention dropout; a model configured with either needs one. On a
    ``mesh`` of several ranks ``model`` may be the DDP wrapper, the batch
    is this rank's share, the draws those of the global batch of which the
    rank keeps its samples' (so every rank's generator moves as one
    process's) and the loss the global batch's (:func:`global_masked_mse`).
    Returns the loss (detached, fp32)."""
    net = getattr(model, "module", model)
    if generator is None and (net.encoder.config.sampling_strategy is not None
                              or net.processor.config.attn_config.atten_dropout > 0):
        raise ValueError("edge drop (magno.sampling_strategy) and attention dropout "
                         "(atten_dropout) draw from a generator: pass train_step a "
                         "torch.Generator on the model's device")
    if generator is not None and mesh is not None and mesh.dp > 1:
        b = sample_mask.shape[0]
        generator = BatchShare(generator, mesh.data_index * b, mesh.dp * b)
    model.train()
    objective, loss = global_masked_mse(
        _forward(model, graphs, coord, pndata, condition, generator),
        target, sample_mask, node_mask, mesh)
    objective.backward()
    if mesh is not None and mesh.spatial:
        # Each rank's gradients are its queries' share: summed over them.
        sum_grads(net.parameters(), mesh.model_group)
    set_lr(optimizer, lr)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss


@torch.no_grad()
def eval_step(model, graphs: FxGraphs, coord: torch.Tensor, pndata: torch.Tensor,
              target: torch.Tensor, sample_mask: torch.Tensor,
              node_mask: Optional[torch.Tensor] = None,
              condition: Optional[torch.Tensor] = None, mesh=None):
    """One evaluation batch: (prediction [B, N, Cout], masked MSE). On a
    ``mesh`` of several ranks the batch is this rank's share, the
    prediction its own and the MSE the global batch's."""
    pred = _forward(model, graphs, coord, pndata, condition)
    return pred, global_masked_mse(pred, target, sample_mask, node_mask, mesh)[1]


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

        cfg = dataset_config
        if is_vx:
            graphs = self._build_vx_graphs(splits, latent)
            loaders = {
                name: None if graphs[name] is None else make_static_vx_loader(
                    splits[name]["c"], splits[name]["u"], graphs[name],
                    cfg.batch_size, shuffle=(cfg.shuffle and name == "train"),
                    seed=self.setup_config.seed, device_data=cfg.device_data,
                    device=self.device)
                for name in ["train", "val", "test"]
            }
        else:
            self._build_fx_graphs(splits["train"]["x"], latent)
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

    def _build_vx_graphs(self, splits: Dict, latent: np.ndarray,
                         cache_suffix: str = "") -> Dict:
        """Every split's vx graphs (``splits[name]["x"]`` [S, N, d]), one
        layout over all splits, through the graph cache where
        ``dataset.graph_cache_dir`` is set (the dataset named
        ``{name}-{coord_scaling}{cache_suffix}``, as the JAX trainers name
        it). Only the linear transforms' graphs are degree-bucketed; the
        nonlinear ones stay dense, the JAX trainers' guard. Under spatial
        parallelism this rank's share of each sample's padded nodes and of
        the latent queries sets :attr:`spatial`, and the graphs are cut to
        its rows (``GraphBuilder.build_all_vx_graphs``); of the ranks that
        build the same cut, the first on the data axis writes the cache."""
        magno, cfg = self.model_config.args.magno, self.dataset_config
        builder = GraphBuilder.from_magno_config(magno)
        mesh = self.mesh
        kw = dict(build_train=self.setup_config.train,
                  model_transform=self.data_processor.coord_scaler,
                  with_transpose=magno.use_transpose_backward,
                  bucketing=(magno.use_query_bucketing and magno.transform_type
                             in ("linear", "linear_kernelonly")))
        if mesh.spatial:
            self.spatial = spatial_shard(
                self.model_config.latent_tokens_size,
                self.model_config.args.transformer.patch_size,
                vx_node_pad(splits, self.setup_config.train), mesh.model_group,
                mesh.model_index, mesh.mp)
            kw["rows"] = (self.spatial.latent, self.spatial.nodes)
        if cfg.graph_cache_dir:
            out = builder.build_all_vx_graphs_cached(
                cfg.graph_cache_dir, f"{cfg.name}-{cfg.coord_scaling}{cache_suffix}",
                splits, latent, magno.radius, magno.scales, ranks=mesh.mp,
                write=mesh.data_index == 0 and (mesh.spatial or mesh.model_index == 0),
                **kw)
        else:
            out = builder.build_all_vx_graphs(splits, latent, magno.radius,
                                              magno.scales, **kw)
        if mesh.spatial:
            self.spatial = self.spatial._replace(widths=next(
                g.draw_widths for g in out.values() if g is not None))
        return out

    def _build_fx_graphs(self, x: np.ndarray, latent: np.ndarray) -> None:
        """The shared fx graphs of the nodes ``x`` [N, d] and the model's
        coordinates, on the trainer's device."""
        magno = self.model_config.args.magno
        coord = self.data_processor.coord_scaler(x)
        enc, dec = GraphBuilder.from_magno_config(magno).build_fx_graphs(
            coord, latent, magno.radius, magno.scales)
        if self.mesh.spatial:
            # This rank's rows: its latent queries in the encoder, its
            # output queries in the decoder; edge drop draws over the uncut
            # graphs' widths.
            self.spatial = sp = spatial_shard(
                self.model_config.latent_tokens_size,
                self.model_config.args.transformer.patch_size, coord.shape[0],
                self.mesh.model_group, self.mesh.model_index, self.mesh.mp)._replace(
                    widths=(fx_draw_widths(enc, magno), fx_draw_widths(dec, magno)))
            enc = [cut_rows(g, *sp.latent) for g in enc]
            dec = [cut_rows(g, *sp.nodes) for g in dec]
        self.coord = torch.from_numpy(coord.astype(np.float32)).to(self.device)
        self.graphs = FxGraphs(self.latent, *prepare_fx_device_graphs(
            enc, dec, coord.shape[0], latent.shape[0], magno, device=self.device))

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
        buffers and its layout (under spatial parallelism this rank's rows
        of them, with all their sources)."""
        sp, counts = self.spatial, None
        if sp is not None:
            counts = VxCounts(sp.num_nodes, self.latent.shape[0],
                              sp.latent[1] - sp.latent[0], sp.nodes[1] - sp.nodes[0])
        return FxGraphs(self.latent, *vx_flat_graphs(
            batch, len(self.model_config.args.magno.scales), counts))

    def _model_args(self, batch: Dict):
        """(graphs, coordinates, node mask or None) of a placed batch; the
        coordinates whole, the node mask this rank's nodes'."""
        if self.coord_mode == "fx":
            return self.graphs, self.coord, None
        return self._batch_graphs(batch), batch["x"], self.local_nodes(batch["node_mask"])

    def _inputs(self, batch: Dict):
        """(model input, target, time condition or None) of a placed batch."""
        return batch["c"], batch["u"], None

    def train_step(self, batch) -> torch.Tensor:
        if "global_samples" not in batch:
            batch = self.place_batch(batch)
        loss = self.step_body(dict(batch, sample_mask=self.sample_mask(batch)),
                              self.schedule(self.step))
        self.step += 1
        return loss

    def step_body(self, batch: Dict, lr) -> torch.Tensor:
        """The step body (:func:`step_update`) on a placed batch whose
        ``sample_mask`` is a tensor on the device, at the learning rate
        ``lr``: what the per-step path and the epoch path both run."""
        graphs, coord, node_mask = self._model_args(batch)
        pndata, target, condition = self._inputs(batch)
        return step_update(self.train_model, self.optimizer, lr, graphs, coord, pndata,
                           self.local_nodes(target), batch["sample_mask"], node_mask,
                           condition, self.generator, self.mesh)

    def _eval(self, batch):
        """(this rank's prediction, the global batch's masked MSE) of one
        batch, in evaluation mode."""
        self.model.eval()
        batch = self.place_batch(batch)
        graphs, coord, node_mask = self._model_args(batch)
        pndata, target, condition = self._inputs(batch)
        return eval_step(self.model, graphs, coord, pndata, self.local_nodes(target),
                         self.sample_mask(batch), node_mask, condition, self.mesh)

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
            pred = self.gather_batch(pred, len(batch["sample_mask"]), node_dim=1)
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
        if self.rank0:
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
