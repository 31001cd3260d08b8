"""Result visualization (the port's copy of ``gaot_tpu/utils/plotting.py``).

- :func:`plot_estimates` — per-variable rows of input / ground truth /
  prediction / |error| scatter panels (reference
  src/utils/plotting.py:48-307),
- :func:`plot_losses` — the loss record (.npz) and the train/val loss
  curves (reference src/core/base_trainer.py:227-272),
- :func:`create_sequential_animation` — the sequential trainer's rollout
  GIF (reference src/utils/plotting.py:310-577).

matplotlib is imported when a figure is drawn, not with the module: a host
without it trains and writes the loss record, and draws no PNG or GIF.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np


def pyplot():
    """matplotlib.pyplot with the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _cmaps(colorbar_type: str):
    """(symmetric, asymmetric, error) colormaps for the two colorbar modes
    (reference plotting.py:361-367: 'light' -> jet, 'dark' -> blue/white/red
    family; we keep perceptually-uniform defaults for 'dark')."""
    if colorbar_type == "light":
        return "jet", "jet", "magma"
    return "RdBu_r", "viridis", "magma"


def _point_size(coords: np.ndarray, base: float = 4.0) -> float:
    """Scale marker size with point density (reference plotting.py:352-354)."""
    return base * 128.0 / max(np.sqrt(coords.shape[0]), 1.0)


def _panel(ax, coords, values, cmap, vmin, vmax, title, size, domain=None):
    sc = ax.scatter(coords[:, 0], coords[:, 1], c=values, cmap=cmap,
                    vmin=vmin, vmax=vmax, s=size)
    if title:
        ax.set_title(title, fontsize=8)
    if domain is not None:
        ax.set_xlim(domain[0][0], domain[1][0])
        ax.set_ylim(domain[0][1], domain[1][1])
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    return sc


def _sym_limits(*arrays):
    vmax = max(float(np.abs(a).max()) for a in arrays) or 1.0
    return -vmax, vmax


def _asym_limits(*arrays):
    vmin = min(float(a.min()) for a in arrays)
    vmax = max(float(a.max()) for a in arrays)
    if vmin == vmax:
        vmin, vmax = vmin - 1.0, vmax + 1.0
    return vmin, vmax


def _per_var(symmetric, n):
    if symmetric is None:
        return [False] * n
    if isinstance(symmetric, (bool, np.bool_)):
        return [bool(symmetric)] * n
    out = list(symmetric)
    return (out + [False] * n)[:n]


def plot_estimates(u_inp: Optional[np.ndarray], u_gtr: np.ndarray,
                   u_prd: np.ndarray, x_inp: np.ndarray,
                   x_out: Optional[np.ndarray] = None,
                   names: Optional[Sequence[str]] = None,
                   symmetric: Union[None, bool, Sequence[bool]] = None,
                   domain=None, colorbar_type: str = "light",
                   show_error: bool = True):
    """One row per variable: Input | Ground truth | Prediction | [|Error|].

    Ground truth and prediction share color limits so they are visually
    comparable; the input column shows input variable i on row i when it
    exists (reference plot_estimates, src/utils/plotting.py:48-307).
    """
    plt = pyplot()
    if plt is None:
        raise ImportError("plot_estimates needs matplotlib")
    x_out = x_inp if x_out is None else x_out
    u_gtr = np.asarray(u_gtr)
    u_prd = np.asarray(u_prd)
    if u_gtr.ndim == 1:
        u_gtr = u_gtr[:, None]
    if u_prd.ndim == 1:
        u_prd = u_prd[:, None]
    n_out = u_gtr.shape[-1]
    n_inp = u_inp.shape[-1] if u_inp is not None else 0
    nrows = max(n_out, n_inp)
    sym = _per_var(symmetric, nrows)
    cmap_sym, cmap_asym, cmap_err = _cmaps(colorbar_type)
    ncols = (1 if n_inp else 0) + 2 + (1 if show_error else 0)
    s_in = _point_size(x_inp)
    s_out = _point_size(x_out)

    fig, axes = plt.subplots(nrows, ncols, figsize=(2.9 * ncols, 2.5 * nrows),
                             squeeze=False)
    for ax in axes.ravel():
        ax.axis("off")

    for v in range(nrows):
        col = 0
        if n_inp:
            ax = axes[v, 0]
            if v < n_inp:
                ax.axis("on")
                label = (names[v] if names and v < len(names)
                         else f"input {v}")
                sc = _panel(ax, x_inp, u_inp[:, v], cmap_asym,
                            *(_asym_limits(u_inp[:, v])),
                            f"in: {label}", s_in, domain)
                plt.colorbar(sc, ax=ax, fraction=0.046,
                             orientation="horizontal", pad=0.04)
            col = 1
        if v >= n_out:
            continue
        cmap = cmap_sym if sym[v] else cmap_asym
        limits = (_sym_limits(u_gtr[:, v], u_prd[:, v]) if sym[v]
                  else _asym_limits(u_gtr[:, v], u_prd[:, v]))
        sc = _panel(axes[v, col], x_out, u_gtr[:, v], cmap, *limits,
                    f"gt[{v}]", s_out, domain)
        axes[v, col].axis("on")
        _panel(axes[v, col + 1], x_out, u_prd[:, v], cmap, *limits,
               f"pred[{v}]", s_out, domain)
        axes[v, col + 1].axis("on")
        plt.colorbar(sc, ax=[axes[v, col], axes[v, col + 1]],
                     fraction=0.03, orientation="horizontal", pad=0.04)
        if show_error:
            err = np.abs(u_gtr[:, v] - u_prd[:, v])
            axe = axes[v, col + 2]
            axe.axis("on")
            sc = _panel(axe, x_out, err, cmap_err, 0.0,
                        float(err.max()) or 1.0, f"|err|[{v}]", s_out, domain)
            plt.colorbar(sc, ax=axe, fraction=0.046,
                         orientation="horizontal", pad=0.04)
    return fig


def plot_losses(path: str, epochs, losses, val_epochs=None, val_losses=None,
                best_epoch=None, best_loss=None):
    """The loss record ``<path without .png>.npz`` (``epochs``, ``losses``,
    ``val_epochs``, ``val_losses``), always, and the loss curves at
    ``path`` where matplotlib imports (reference base_trainer.py:227-272)."""
    kwargs = {"epochs": epochs, "losses": losses}
    if val_losses:
        kwargs.update(val_epochs=val_epochs, val_losses=val_losses)
    np.savez(path[:-4] + ".npz", **kwargs)
    plt = pyplot()
    if plt is None:
        return
    if val_losses:
        fig, ax = plt.subplots(1, 2, figsize=(12, 6))
        ax0, ax1 = ax
    else:
        fig, ax0 = plt.subplots(figsize=(8, 6))
        ax1 = None
    ax0.plot(epochs, losses)
    if best_epoch is not None:
        ax0.scatter([best_epoch], [best_loss], c="r", marker="o", label="best loss")
        ax0.legend()
    ax0.set_xlabel("Epoch")
    ax0.set_ylabel("Loss")
    ax0.set_xlim(left=0)
    if len(losses) and (np.asarray(losses) > 0).all():
        ax0.set_yscale("log")
    if ax1 is not None:
        ax1.plot(val_epochs, val_losses)
        ax1.set_xlabel("Epoch")
        ax1.set_ylabel("val loss")
        ax1.set_xlim(left=0)
        if (np.asarray(val_losses) > 0).all():
            ax1.set_yscale("log")
    fig.savefig(path)
    plt.close(fig)


def create_sequential_animation(gt_sequence: np.ndarray, pred_sequence: np.ndarray,
                                coords: np.ndarray, save_path: str,
                                input_data: Optional[np.ndarray] = None,
                                time_values: Optional[Sequence] = None,
                                interval: int = 800,
                                symmetric: Union[None, bool, Sequence[bool]] = None,
                                domain=None, names: Optional[Sequence[str]] = None,
                                colorbar_type: str = "light",
                                show_error: bool = True) -> bool:
    """Rollout GIF over every channel: one row per variable, columns
    [input] | ground truth | prediction | [|error|], color limits fixed
    across the whole sequence (reference plotting.py:310-577).

    gt_sequence, pred_sequence: [n_steps, n_points, n_channels];
    input_data: an optional static [n_points, n_in] first column. Returns
    whether the GIF was written: nothing is drawn, with a message, for
    coordinates that are not 2D or where matplotlib or Pillow is missing."""
    plt = pyplot()
    if plt is None:
        print("matplotlib is not installed: no animation")
        return False
    try:
        import PIL  # noqa: F401  (PillowWriter's back end)
    except ImportError:
        print("Pillow is not installed: no animation")
        return False
    from matplotlib.animation import FuncAnimation, PillowWriter

    if coords.shape[1] != 2:
        print("Animation currently only supports 2D coordinates")
        return False
    gt = np.asarray(gt_sequence)
    pr = np.asarray(pred_sequence)
    if gt.ndim == 2:
        gt, pr = gt[..., None], pr[..., None]
    steps, _, n_ch = gt.shape
    sym = _per_var(symmetric, n_ch)
    cmap_sym, cmap_asym, cmap_err = _cmaps(colorbar_type)
    has_inp = input_data is not None
    ncols = (1 if has_inp else 0) + 2 + (1 if show_error else 0)
    size = _point_size(coords, base=2.5)

    fig, axes = plt.subplots(n_ch, ncols, figsize=(2.9 * ncols, 2.5 * n_ch),
                             squeeze=False)
    gt_scs, pr_scs, err_scs = [], [], []
    for v in range(n_ch):
        col = 0
        if has_inp:
            j = min(v, input_data.shape[-1] - 1)
            sc = _panel(axes[v, 0], coords, input_data[:, j], cmap_asym,
                        *_asym_limits(input_data[:, j]), "input" if v == 0 else "",
                        size, domain)
            plt.colorbar(sc, ax=axes[v, 0], fraction=0.046)
            col = 1
        cmap = cmap_sym if sym[v] else cmap_asym
        limits = (_sym_limits(gt[..., v], pr[..., v]) if sym[v]
                  else _asym_limits(gt[..., v], pr[..., v]))
        label = names[v] if names and v < len(names) else f"var {v}"
        sc_g = _panel(axes[v, col], coords, gt[0, :, v], cmap, *limits,
                      f"gt: {label}", size, domain)
        sc_p = _panel(axes[v, col + 1], coords, pr[0, :, v], cmap, *limits,
                      f"pred: {label}", size, domain)
        plt.colorbar(sc_p, ax=[axes[v, col], axes[v, col + 1]], fraction=0.03)
        gt_scs.append(sc_g)
        pr_scs.append(sc_p)
        if show_error:
            err_all = np.abs(gt[..., v] - pr[..., v])
            sc_e = _panel(axes[v, col + 2], coords, err_all[0], cmap_err,
                          0.0, float(err_all.max()) or 1.0,
                          f"|err|: {label}", size, domain)
            plt.colorbar(sc_e, ax=axes[v, col + 2], fraction=0.046)
            err_scs.append(sc_e)

    def update(frame):
        for v in range(n_ch):
            gt_scs[v].set_array(gt[frame, :, v])
            pr_scs[v].set_array(pr[frame, :, v])
            if show_error:
                err_scs[v].set_array(np.abs(gt[frame, :, v] - pr[frame, :, v]))
        label = (time_values[frame] if time_values is not None
                 and frame < len(time_values) else frame)
        fig.suptitle(f"t = {label}")
        return gt_scs + pr_scs + err_scs

    anim = FuncAnimation(fig, update, frames=steps, interval=interval, blit=False)
    anim.save(save_path, writer=PillowWriter(fps=max(1, 1000 // interval)))
    plt.close(fig)
    return True
