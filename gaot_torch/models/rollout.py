"""Autoregressive rollout for time-dependent problems.

Counterpart of ``gaot_tpu/models/rollout.py``, whose single ``lax.scan``
over the steps becomes a loop of forwards here: each step feeds the
previous step's prediction back as the next input, with the step's time
features, and undoes the stepper mode's normalisation ('output',
'residual' or 'time_der'; reference gaot.py:436-477). It runs on fx and vx
batches alike, with the graph arguments of either.

The per-step time features and the statistics go to the model's device
once, before the loop (a pageable host-to-device copy would wait for the
device's queued work); inside the loop nothing is copied and no row is
gathered: a step's features are views of those tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.sequential import STEPPER_MODES
from ..parallel.spatial import gather_nodes


def _to(a, device, dtype=torch.float32) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a, dtype=np.float32), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@torch.no_grad()
def autoregressive_predict(model, x_batch: torch.Tensor, time_indices,
                           t_values, stats: Dict, stepper_mode: str, graphs,
                           coord: torch.Tensor,
                           use_conditional_norm: bool = False) -> torch.Tensor:
    """Roll ``model`` forward over ``time_indices``.

    Args:
        x_batch: [B, N, in] initial features on the model's device,
            ``[u(t0)_norm ‖ c_norm ‖ two time features]`` (the layout of
            the reference TestDataset, src/datasets/data_utils.py:383-392).
        time_indices: [T] step indices into ``t_values``.
        t_values: [T_total] physical times.
        stats: the sequential statistics ('u', optional 'c', 'start_time',
            'time_diffs', 'res' / 'der').
        graphs: the model's graph arguments (``FxGraphs``: the latent grid
            and the per-scale graphs, fx or a vx batch's).
        coord: the node coordinates ([N, d] fx, [B, N_pad, d] vx).

    Returns:
        The predictions [B, T-1, N, u_dim], not normalised (fp32).
    """
    if stepper_mode not in STEPPER_MODES:
        raise ValueError(f"Unsupported stepper_mode: {stepper_mode}")
    time_indices = np.asarray(time_indices)
    t_values = np.asarray(t_values)
    device = x_batch.device

    u_mean = _to(stats["u"]["mean"], device)
    u_std = _to(stats["u"]["std"], device)
    u_dim = u_mean.shape[0]
    c_dim = np.asarray(stats["c"]["mean"]).shape[0] if "c" in stats else 0

    # The per-step time features, [3, T-1]: normalised start time and
    # time difference, and the raw time difference (reference
    # gaot.py:365-388 recomputes them each step).
    t_in, t_out = time_indices[:-1], time_indices[1:]
    start_times = t_values[t_in]
    time_diffs = t_values[t_out] - t_values[t_in]
    st, td = stats["start_time"], stats["time_diffs"]
    per_step = _to(np.stack([
        (start_times - float(np.asarray(st["mean"]))) / float(np.asarray(st["std"])),
        (time_diffs - float(np.asarray(td["mean"]))) / float(np.asarray(td["std"])),
        time_diffs]), device, x_batch.dtype)
    step = {"residual": "res", "time_der": "der"}.get(stepper_mode)
    if step is not None:
        step_mean, step_std = _to(stats[step]["mean"], device), _to(stats[step]["std"], device)

    c_features = x_batch[..., u_dim:u_dim + c_dim] if c_dim else None
    u_norm = x_batch[..., :u_dim]
    b, n = u_norm.shape[:2]
    ones = torch.ones((b, n, 1), dtype=u_norm.dtype, device=device)
    preds = []
    for i in range(len(t_in)):
        s_norm, d_norm, d_raw = per_step[:, i]
        feats = [u_norm] if c_features is None else [u_norm, c_features]
        x_input = torch.cat(feats + [ones * s_norm, ones * d_norm], dim=-1)
        # A conditional-norm model drops the time difference and takes the
        # start time as its condition.
        pndata, cond = ((x_input[..., :-1], x_input[:, 0, -2:-1])
                        if use_conditional_norm else (x_input, None))
        pred = model(graphs.latent_tokens_coord, coord, pndata, graphs.encoder,
                     graphs.decoder, encoder_tgraphs=graphs.encoder_t,
                     decoder_tgraphs=graphs.decoder_t, condition=cond)
        # Under spatial parallelism each rank predicts its nodes; the next
        # step reads them all.
        pred = gather_nodes(pred, getattr(model, "spatial", None), 1)
        # Stepper-mode denormalisation (reference gaot.py:454-472).
        if stepper_mode == "output":
            pred_denorm = pred * u_std + u_mean
        elif stepper_mode == "residual":
            pred_denorm = (u_norm * u_std + u_mean) + (pred * step_std + step_mean)
        else:
            pred_denorm = (u_norm * u_std + u_mean) + d_raw * (pred * step_std + step_mean)
        u_norm = (pred_denorm - u_mean) / u_std
        preds.append(pred_denorm)
    return torch.stack(preds, dim=1)
