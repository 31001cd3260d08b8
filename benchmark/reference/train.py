"""The plain reference of the static recipe's data handling and training.

- :func:`prepare`: the splits (the first ``train_size`` samples, the next
  ``val_size``, the last ``test_size``), z-scores of ``u`` and ``c`` over
  the training split, coordinates min-max scaled to [-1, 1] over the
  dataset's domain, the latent grid (row-major, ``linspace`` over the
  domain), and every graph built again from the coordinates
  (:mod:`.graphs`): one pair for a point cloud the samples share; for a
  mesh per sample, its nodes in Z-order, searched on their own min-max
  rescale, with the draw widths of edge drop over every split;
- :func:`epoch_order`, :func:`mix_lr`: the sample order of the first
  epoch (a permutation from ``default_rng(seed)``) and the 'mix' schedule
  (linear warm-up, cosine, exponential decay over the epochs);
- :func:`train_steps`: steps of masked MSE, its gradients by autograd and
  AdamW (decoupled weight decay, betas 0.9 / 0.999, eps 1e-8), each step's
  edge drop drawn from a generator seeded as the recipe seeds its own.

Everything in float32 with TF32 off unless the caller turns it on (the
control). Nothing here imports the measured program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import graphs as G
from .model import Params, Shapes, forward

EPS = 1e-10
# A mesh's node rows are padded to a multiple of this; edge drop draws over
# the padded rows.
NODE_PAD = 64


def _domain_scale(x: np.ndarray, domain) -> np.ndarray:
    lo, hi = np.asarray(domain[0], np.float64), np.asarray(domain[1], np.float64)
    span = np.where(hi - lo == 0, 1.0, hi - lo)
    return ((np.asarray(x, np.float64) - lo) / span * 2.0 - 1.0).astype(np.float32)


def prepare(arrays: Dict[str, np.ndarray], config: dict, layout: dict, device) -> dict:
    """Normalised splits, coordinates and graphs of the benchmark's arrays."""
    ds = config["dataset"]
    tr, va, te = ds["train_size"], ds["val_size"], ds["test_size"]
    u, c, x = arrays["u"][:, 0], arrays["c"][:, 0], arrays["x"][:, 0]
    total = u.shape[0]
    sl = {"train": slice(0, tr), "val": slice(tr, tr + va), "test": slice(total - te, total)}
    u_tr, c_tr = u[sl["train"]], c[sl["train"]]
    u_mean = u_tr.reshape(-1, u.shape[-1]).mean(0)
    u_std = u_tr.reshape(-1, u.shape[-1]).std(0) + EPS
    c_mean = c_tr.reshape(-1, c.shape[-1]).mean(0)
    c_std = c_tr.reshape(-1, c.shape[-1]).std(0) + EPS
    domain = layout["domain"]
    shapes = Shapes(config["model"], c.shape[-1], u.shape[-1])
    axes = [np.linspace(domain[0][i], domain[1][i], shapes.grid[i])
            for i in range(len(shapes.grid))]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(shapes.grid))
    latent = torch.from_numpy(_domain_scale(grid, domain)).to(device)
    radius = shapes.radius
    out = {"shapes": shapes, "latent": latent, "slices": sl, "shared": x.shape[0] == 1,
           "u": ((u - u_mean) / u_std).astype(np.float32),
           "c": ((c - c_mean) / c_std).astype(np.float32)}
    if out["shared"]:
        coords = torch.from_numpy(_domain_scale(x[0], domain)).to(device)
        out["samples"] = [(coords, G.radius_graph(coords, latent, radius),
                           G.radius_graph(latent, coords, radius))]
        return out
    # A mesh per sample: Z-order, the search on each sample's own rescale,
    # the model on the domain's scale.
    perms, meshes, enc_deg, dec_deg = [], [], [], []
    used = list(range(0, tr + va)) + list(range(total - te, total))
    for i in used:
        perm = G.morton_order(x[i])
        xr = x[i].astype(np.float64)[perm]
        search = torch.from_numpy(G.rescale(xr).astype(np.float32)).to(device)
        coords = torch.from_numpy(_domain_scale(xr, domain)).to(device)
        enc = G.radius_graph(search, latent, radius)
        dec = G.radius_graph(latent, search, radius)
        perms.append(perm)
        meshes.append((coords, enc, dec))
        enc_deg.append(enc.deg.cpu().numpy())
        dec_deg.append(dec.deg.cpu().numpy())
    out["perm"] = dict(zip(used, perms))
    out["meshes"] = dict(zip(used, meshes))
    out["widths"] = (G.draw_width(np.stack(enc_deg)), G.draw_width(np.stack(dec_deg)))
    return out


def epoch_order(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


def mix_lr(args: dict, steps_per_epoch: int, step: int) -> float:
    """The 'mix' schedule of AdamW (warm-up 2%, cosine 90% of the epochs)."""
    epochs = args["epoch"]
    warm, cos = int(0.02 * epochs), int(0.90 * epochs)
    exp_decay = epochs - warm - cos
    if warm == 0:
        warm, cos = 1, cos - 1
    if exp_decay == 0:
        exp_decay, cos = 1, cos - 1
    lr0, mx, mn, fin = args["lr"], args["max_lr"], args["min_lr"], args["final_lr"]
    e = step // steps_per_epoch
    if e < warm:
        return lr0 + (mx - lr0) * (e / max(1, warm - 1))
    if e < warm + cos:
        return mn + (mx - mn) * (1 + math.cos(math.pi * (e - warm) / cos)) / 2
    return mn * (fin / mn) ** ((e - warm - cos) / max(1, exp_decay - 1))


def batch(prep: dict, rows: np.ndarray, generator: Optional[torch.Generator],
          max_neighbors: Optional[int], device):
    """(samples, inputs [B, N, cin], target [B, N, cout]) of training rows
    ``rows``; a mesh per sample is in its Z-order, its graphs thinned by
    edge drop where ``generator`` is given (one draw a side over the
    batch's rows, the encoder's first; none for a side whose draw width is
    at most ``max_neighbors``)."""
    c = torch.from_numpy(prep["c"][rows]).to(device)
    u = torch.from_numpy(prep["u"][rows]).to(device)
    if prep["shared"]:
        return prep["samples"], c, u
    perm = [prep["perm"][int(r)] for r in rows]
    c = torch.stack([c[i][torch.from_numpy(p).to(device)] for i, p in enumerate(perm)])
    u = torch.stack([u[i][torch.from_numpy(p).to(device)] for i, p in enumerate(perm)])
    meshes = [prep["meshes"][int(r)] for r in rows]
    if generator is not None and max_neighbors:
        b = len(rows)
        q_lat, n = prep["latent"].shape[0], meshes[0][0].shape[0]
        rows_dec = -(-n // NODE_PAD) * NODE_PAD     # the draw covers padded node rows

        def thinned(graphs, q, width):
            # A side no wider than max_neighbors keeps every edge, and
            # nothing is drawn for it.
            if width <= max_neighbors:
                return graphs
            u = torch.rand((b * q, width), generator=generator, device=device).view(
                b, q, width)[:, :len(graphs[0].deg)]
            return [g.keep(G.max_neighbors_keep(g, u[i], max_neighbors))
                    for i, g in enumerate(graphs)]

        w_enc, w_dec = prep["widths"]
        enc = thinned([e for _, e, _ in meshes], q_lat, w_enc)
        dec = thinned([d for _, _, d in meshes], rows_dec, w_dec)
        meshes = [(xy, e, d) for (xy, _, _), e, d in zip(meshes, enc, dec)]
    return meshes, c, u


def train_steps(params: Params, prep: dict, config: dict, seed: int, steps: int,
                device, draw_seed: Optional[int] = None, keep: float = 1.0,
                frozen_draws: bool = False, follow: Optional[List[Params]] = None) -> dict:
    """``steps`` steps from ``params`` on the first epoch's batches. Returns
    each step's loss, every gradient of the first step, every parameter
    after each step but the last (``params_at``) and after the last.
    ``follow``: another side's weights after each step but the last; at
    each step from the second, the loss of that side's weights of the step
    before on this step's batch and draws (``followed``). Faults planted
    for calibration: ``keep`` < 1,
    the loss over the batch's first ``keep`` share of samples alone;
    ``frozen_draws``, every step's edge drop drawn from the generator's
    state before the first (draws that do not advance from step to step)."""
    shapes: Shapes = prep["shapes"]
    args = config["optimizer"]["args"]
    bsz = config["dataset"]["batch_size"]
    n_train = config["dataset"]["train_size"]
    per_epoch = -(-n_train // bsz)
    order = epoch_order(seed, n_train)
    p = {k: v.detach().clone().to(device).requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, args["weight_decay"]
    gen = None
    if shapes.sampling == "max_neighbors" and shapes.max_neighbors:
        gen = torch.Generator(device=device).manual_seed(
            int(seed if draw_seed is None else draw_seed))
    start = gen.get_state() if gen is not None else None
    losses, first_grad, params_at, followed = [], None, [], []
    for t in range(steps):
        rows = order[t * bsz:(t + 1) * bsz]
        if frozen_draws and gen is not None:
            gen.set_state(start)
        samples, inp, target = batch(prep, rows, gen, shapes.max_neighbors, device)
        if follow and t > 0:
            with torch.no_grad():
                w = {k: v.to(device) for k, v in follow[t - 1].items()}
                followed.append(float(((forward(w, shapes, prep["latent"], samples, inp)
                                        - target) ** 2).mean()))
                del w
        pred = forward(p, shapes, prep["latent"], samples, inp)
        used = max(1, int(round(keep * pred.shape[0])))
        loss = ((pred[:used] - target[:used]) ** 2).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(p, grads)}
        lr = mix_lr(args, per_epoch, t)
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                w.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** (t + 1))
                vhat = v2[k] / (1 - b2 ** (t + 1))
                w.sub_(lr * mhat / (vhat.sqrt() + eps))
        if t < steps - 1:
            params_at.append({k: w.detach().clone() for k, w in p.items()})
        del pred, loss, grads
    return {"losses": losses, "grad": first_grad, "params_at": params_at,
            "followed": followed, "params": {k: w.detach() for k, w in p.items()}}


@torch.no_grad()
def predict(params: Params, prep: dict, rows: List[int], device, block: int = 32) -> torch.Tensor:
    """The model's prediction of dataset rows ``rows`` (a shared point
    cloud), ``block`` samples at a time. Returns [len(rows), N, cout]."""
    p = {k: v.to(device) for k, v in params.items()}
    outs = []
    for i in range(0, len(rows), block):
        r = np.asarray(rows[i:i + block])
        samples, c, _ = batch(prep, r, None, None, device)
        outs.append(forward(p, prep["shapes"], prep["latent"], samples, c).cpu())
    return torch.cat(outs)
