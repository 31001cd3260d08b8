"""The MAGNO options on vx batches (a mesh per sample) in the port against
the JAX package, on the CPU: every ``magno.transform_type``,
``node_embedding`` and a nonlinear transform under edge drop.

The whole GAOT at the sizes of ``tests/test_torch_vx.py`` (batch 2, 90
nodes a sample, an 8x8 grid), the split built by the JAX package's builder
and taken by both sides, the JAX weights loaded strictly, fp32. The graphs
are laid out as the trainers lay them out, the linear transforms' degree
bucketed and the nonlinear ones' dense, apart from ``linear_kernelonly``,
held dense: bucketed it takes ``linear``'s route in both packages, dense
the JAX package takes its plain autodiff route and the port its reduce.
Per transform and per side, the forward and every parameter gradient of
that side (the encoder's with the processor's, or the decoder's) against
``jax.grad`` of the masked MSE. Bounds are ``tests/test_torch_vx.py``'s:
the forward rtol 1e-4 / atol 1e-5, each gradient within 1e-4 of its
tensor's largest entry.

Edge drop: the port draws the masks with its generator and both sides get
the dropped graphs (``tests/test_torch_edge_drop.py``'s harness, whose JAX
forward in evaluation mode on those masks is its training path with them).

The static and the sequential trainer build on vx data with each option
(the graph cache twice, the second a hit) and without transpose graphs on
fx too, and take training steps with finite losses.
"""
import copy
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_edge_drop as ed  # noqa: E402

RTOL, ATOL, GRAD = 1e-4, 1e-5, 1e-4

# name: (layout, MAGNO overrides)
RUNS = {
    "linear": ("vx_bucketed", {"transform_type": "linear"}),
    "linear_kernelonly": ("vx_dense", {"transform_type": "linear_kernelonly"}),
    "nonlinear": ("vx_dense", {"transform_type": "nonlinear"}),
    "nonlinear_kernelonly": ("vx_dense", {"transform_type": "nonlinear_kernelonly"}),
    "node_embedding_dense": ("vx_dense", {"node_embedding": True}),
    "node_embedding_bucketed": ("vx_bucketed", {"node_embedding": True}),
}
TRANSFORMS = [n for n in RUNS if not n.startswith("node_embedding")]


def _cfg(name):
    layout, magno = RUNS[name]
    return layout, ed.model_cfg(layout, ed.VX_GRID, ed.VX_RADIUS, **magno)


def _check(pred, grads, want_pred, want, prefixes=("",)):
    np.testing.assert_allclose(pred, want_pred, rtol=RTOL, atol=ATOL)
    assert grads.keys() == want.keys()
    names = [n for n in want if n.startswith(prefixes)]
    assert names
    for n in names:
        w = want[n].reshape(grads[n].shape)
        err = np.abs(grads[n] - w).max()
        assert err <= GRAD * max(np.abs(w).max(), 1e-30), (n, err)


@functools.lru_cache(maxsize=None)
def _run(name):
    """(pred, grads, JAX pred, JAX grads, the port's routes, JAX's initial
    parameters) of one run."""
    from gaot_torch.utils.routing import format_routes, reset_routes

    layout, cfg = _cfg(name)
    coords, lat, pn, tgt, nmask, jgraphs, tgraphs = ed.workload(layout, cfg)
    if layout == "vx_bucketed":
        assert all(hasattr(g, "bucket_ks") for g in jgraphs[0] + jgraphs[1])
    params, want_pred, want = ed.jax_run(cfg, coords, lat, pn, tgt, nmask, jgraphs)
    reset_routes()
    pred, grads = ed.torch_run(ed.torch_model(cfg, params), coords, lat, pn, tgt,
                               nmask, tgraphs)
    return pred, grads, want_pred, want, format_routes(), params


@pytest.mark.parametrize("side", ["encoder", "decoder"])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_vx_transform_matches_jax(name, side):
    pred, grads, want_pred, want, routes, _ = _run(name)
    prefixes = ("encoder.", "processor.") if side == "encoder" else ("decoder.",)
    _check(pred, grads, want_pred, want, prefixes)
    nonlinear = name.startswith("nonlinear")
    assert routes.startswith("agno=vx-plain" if nonlinear else "agno=vx:plain "), routes


@pytest.mark.parametrize("name", ["node_embedding_dense", "node_embedding_bucketed"])
def test_vx_node_embedding_matches_jax(name):
    """The kernel reads the Fourier encodings of the coordinate rows, the
    geometric embedding the raw rows."""
    pred, grads, want_pred, want, _, _ = _run(name)
    _check(pred, grads, want_pred, want)


def test_vx_nonlinear_edge_drop_matches_jax():
    """A nonlinear vx GAOT on the masks the port's edge drop draws: both
    sides on the same dropped graphs, and a training forward given the
    generator draws those masks again."""
    cfg = ed.model_cfg("vx_dense", ed.VX_GRID, ed.VX_RADIUS, transform_type="nonlinear",
                       sampling_strategy="ratio", sample_ratio=0.4)
    coords, lat, pn, tgt, nmask, jgraphs, tgraphs = ed.workload("vx_dense", cfg)
    params = _run("nonlinear")[-1]      # the same weights: the drop draws none
    model = ed.torch_model(cfg, params)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    dropped = ed.drop_graphs(model, tgraphs, gen)
    thinned = sum(int(a.sum() - d.sum())
                  for b, a_ in zip(tgraphs[0] + tgraphs[1], dropped[0] + dropped[1])
                  for a, d in zip(ed.masks(b), ed.masks(a_)))
    assert thinned > 0
    jd = (*[[ed.with_masks(j, t) for j, t in zip(jgraphs[i], dropped[i])]
            for i in (0, 1)], jgraphs[2], jgraphs[3])
    _, want_pred, want = ed.jax_run(cfg, coords, lat, pn, tgt, nmask, jd)
    pred, grads = ed.torch_run(model, coords, lat, pn, tgt, nmask, dropped)
    _check(pred, grads, want_pred, want)
    gen.set_state(state)
    pred_g, grads_g = ed.torch_run(model, coords, lat, pn, tgt, nmask, tgraphs, gen)
    np.testing.assert_array_equal(pred_g, pred)
    for n in grads:
        np.testing.assert_array_equal(grads_g[n], grads[n], err_msg=n)


# The trainers take every option on vx (and, without transpose graphs, on
# fx): a few training steps each at the toy sizes of tests/test_train_e2e.py.
TRAINER_OPTIONS = {
    "linear_kernelonly": {"transform_type": "linear_kernelonly"},
    "nonlinear": {"transform_type": "nonlinear"},
    "nonlinear_kernelonly": {"transform_type": "nonlinear_kernelonly"},
    "node_embedding": {"node_embedding": True},
    "no_transpose": {"use_transpose_backward": False},
    "cache": {"transform_type": "nonlinear", "node_embedding": True},
}


@pytest.mark.parametrize("option", list(TRAINER_OPTIONS) + ["no_transpose_fx"])
@pytest.mark.parametrize("kind", ["static", "sequential"])
def test_trainers_train_with_the_option(tmp_path, kind, option):
    from synthetic import (make_sequential_fx_dataset, make_sequential_vx_dataset,
                           make_static_vx_dataset)
    from test_torch_seq_trainer import FX, _config
    from test_torch_sequential import VX_META, vx_metadata
    from test_torch_vx_trainer import _vx_config

    from gaot_torch.train import SequentialTrainer, StaticTrainer

    fx = option == "no_transpose_fx"
    if kind == "static":
        if fx:
            from test_torch_trainer import _config as _static_config
            cfg = _static_config(tmp_path, "toy")
        else:
            make_static_vx_dataset(str(tmp_path / "airfoil_toy.npz"))
            cfg = _vx_config(tmp_path, "toy")
        cls = StaticTrainer
    else:
        if fx:
            make_sequential_fx_dataset(str(tmp_path / "ns_toy.npz"))
            ds = FX
        else:
            make_sequential_vx_dataset(str(tmp_path / "seq_vx_toy.npz"))
            ds = {"name": "seq_vx_toy", "metaname": VX_META, "train_size": 6,
                  "val_size": 2, "test_size": 2, "batch_size": 4,
                  "stepper_mode": "output"}
        cfg = _config(tmp_path, "toy", ds)
        cls = SequentialTrainer
    cfg["model"]["args"]["magno"].update(
        TRAINER_OPTIONS["no_transpose" if fx else option])
    if option == "cache":
        cfg["dataset"]["graph_cache_dir"] = str(tmp_path / "cache")
    with vx_metadata():
        trainers = [cls(copy.deepcopy(cfg)) for _ in range(2 if option == "cache" else 1)]
    trainer = trainers[-1]
    assert trainer.coord_mode == ("fx" if fx else "vx")
    if option == "cache":
        assert len(list((tmp_path / "cache").glob("*.npz"))) == 1
    losses = [float(trainer.train_step(batch)) for batch, _ in
              zip(trainer.train_loader, range(2))]
    assert len(losses) == 2 and np.isfinite(losses).all()
