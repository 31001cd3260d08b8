"""Optimizers and learning-rate schedules.

The port's own copy of ``gaot_tpu/train/schedules.py``: Adam/AdamW and the
'step' / 'cos' / 'exp' / 'mix' schedules of the reference optimizer zoo
(src/utils/optimizers.py), as per-optimizer-step functions of
``step // steps_per_epoch``. The 'mix' schedule is the reference
CustomLRScheduler: linear warmup initial_lr→max_lr, cosine max_lr→min_lr,
exponential min_lr→final_lr, with warmup/cosine fractions 0.02/0.96 for
Adam and 0.02/0.90 for AdamW.

The schedule is read at the optimizer's update count, counted from 0, as
optax reads it: the caller sets each param group's learning rate to
``schedule(step)`` before ``optimizer.step()`` (:func:`set_lr`; no
``LambdaLR``, whose count is one ahead).

On the card the optimizer can be captured in a CUDA graph
(``capturable=True``; ``train/graphed.py``): its learning rate is a
0-dimensional device tensor, written before each update from a float
(a step issued from the host) or from a row of the epoch's table of
schedule values (:func:`lr_table`, read by the step counter on the device).
Both routes write the same fp32 value, so they take the same update. On
the CPU the learning rate stays a float.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Tuple, Union

import numpy as np
import torch

from ..core.config import OptimizerConfig


def mix_schedule(total_epochs: int, steps_per_epoch: int, initial_lr: float,
                 max_lr: float, min_lr: float, final_lr: float,
                 cosine_frac: float) -> Callable[[int], float]:
    warmup = int(0.02 * total_epochs)
    cosine = int(cosine_frac * total_epochs)
    exp_decay = total_epochs - warmup - cosine
    if warmup == 0:
        warmup, cosine = 1, cosine - 1
    if exp_decay == 0:
        exp_decay, cosine = 1, cosine - 1

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < warmup:                      # linear warmup
            return initial_lr + (max_lr - initial_lr) * (epoch / max(1, warmup - 1))
        if epoch < warmup + cosine:             # cosine max_lr → min_lr
            ratio = (1 + math.cos(math.pi * (epoch - warmup) / cosine)) / 2
            return min_lr + (max_lr - min_lr) * ratio
        ee = epoch - warmup - cosine            # exponential min_lr → final_lr
        return min_lr * (final_lr / min_lr) ** (ee / max(1, exp_decay - 1))

    return schedule


def make_schedule(config: OptimizerConfig,
                  steps_per_epoch: int) -> Callable[[int], float]:
    args = config.args
    name = args.scheduler
    if name == "mix":
        cosine_frac = 0.90 if config.name == "adamw" else 0.96
        return mix_schedule(args.epoch, steps_per_epoch, args.lr, args.max_lr,
                            args.min_lr, args.final_lr, cosine_frac)
    if name == "step":
        return lambda step: args.lr * args.scheduler_gamma ** (
            step // steps_per_epoch // args.scheduler_step_size)
    if name == "cos":
        def cos_sched(step: int) -> float:
            epoch = min(step // steps_per_epoch, args.scheduler_T_max)
            ratio = (1 + math.cos(math.pi * epoch / args.scheduler_T_max)) / 2
            return args.scheduler_eta_min + (args.lr - args.scheduler_eta_min) * ratio
        return cos_sched
    if name == "exp":
        return lambda step: args.lr * args.scheduler_gamma ** (step // steps_per_epoch)
    return lambda step: args.lr                # constant


def make_optimizer(config: OptimizerConfig, params,
                   steps_per_epoch: int) -> Tuple[torch.optim.Optimizer, Callable]:
    """The optimizer over ``params`` and its schedule function, with optax's
    Adam constants (betas (0.9, 0.999), eps 1e-8); capturable, with a
    device tensor for its learning rate, where the parameters lie on the
    card (:func:`make_capturable`)."""
    schedule = make_schedule(config, steps_per_epoch)
    params = list(params)
    kw = dict(lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    if config.name == "adamw":
        opt = torch.optim.AdamW(params, weight_decay=config.args.weight_decay, **kw)
    elif config.name == "adam":
        opt = torch.optim.Adam(params, **kw)
    else:
        raise ValueError(f"Unsupported optimizer: {config.name}")
    if config.args.loss_scale != 1.0:
        # bf16 compute with fp32 parameters needs no loss scaling, and the
        # reference ignores the knob too.
        warnings.warn("optimizer.args.loss_scale is accepted for config "
                      "compatibility but ignored (matches the reference)")
    return make_capturable(opt), schedule


def make_capturable(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """On the card, make ``optimizer`` one a CUDA graph can capture:
    ``capturable`` set, the learning rate a 0-dimensional fp32 tensor on
    the parameters' device and the update counts there too (also after
    ``load_state_dict`` of a state saved elsewhere, which sets both back).
    Parameters on the CPU leave it as it is."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        if device.type != "cuda":
            continue
        group["capturable"] = True
        lr = group["lr"]
        if not torch.is_tensor(lr) or lr.device != device or lr.dtype != torch.float32:
            group["lr"] = torch.tensor(float(lr), dtype=torch.float32, device=device)
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if torch.is_tensor(st.get("step")) and st["step"].device != device:
                st["step"] = st["step"].to(device=device, dtype=torch.float32)
    return optimizer


def set_lr(optimizer: torch.optim.Optimizer, lr: Union[float, torch.Tensor]) -> None:
    """Set every param group's learning rate to ``lr``, a float or a
    0-dimensional tensor (a row of :func:`lr_table`): in place where the
    group's rate is a device tensor (nothing crosses to the host, so a CUDA
    graph can capture it), else as a float."""
    for group in optimizer.param_groups:
        cur = group["lr"]
        if torch.is_tensor(cur):
            cur.copy_(lr) if torch.is_tensor(lr) else cur.fill_(lr)
        else:
            group["lr"] = float(lr)


def lr_table(schedule: Callable[[int], float], first: int, k: int) -> np.ndarray:
    """The schedule's values at updates ``first .. first + k - 1`` (one
    epoch of the epoch path), float64 as the host computes them."""
    return np.array([schedule(first + j) for j in range(k)], dtype=np.float64)
