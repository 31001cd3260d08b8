"""A run of the harness with the timed path broken underneath must come out
not correct (``correct`` false), once for each fault a cell can have: a
training step that leaves the state unchanged, a training step that leaves
half of the batch out (the mean over the rest), edge drop's draws that do
not advance from step to step, an answer altered where the forward
produces it. (No cell spans several cards, so no exchange between
them can be left out.) The runs skip the look for a card and run on the CPU
at a small size."""
import json
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny


def _run(config, traffic, limits, mode):
    args = bench_run.parse(["--workload", "t", "--seed", "99", "--seconds", "0.5",
                            "--trace", "0"])
    rc, line = bench_run.run(args, spec=tiny.cell("t", "x", mode), device="cpu",
                             config=config, traffic=traffic, limits=limits,
                             start=time.perf_counter())
    assert rc == 0
    return json.loads(line)


@pytest.mark.parametrize("config", [tiny.FX, tiny.VX, tiny.VX_CAPPED],
                         ids=["fx", "vx", "vx_capped"])
def test_unbroken_runs_are_correct(config):
    assert _run(config, tiny.TRAIN, tiny.LIMITS_TRAIN, "train")["correct"]


@pytest.mark.parametrize("config", [tiny.FX, tiny.VX], ids=["fx", "vx"])
def test_step_leaving_the_state_unchanged(monkeypatch, config):
    from gaot_torch.train import static_trainer as st

    inner = st.step_update

    def frozen(model, optimizer, *a, **k):
        net = getattr(model, "module", model)
        before = {n: p.detach().clone() for n, p in net.named_parameters()}
        loss = inner(model, optimizer, *a, **k)
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(before[n])
        return loss

    monkeypatch.setattr(st, "step_update", frozen)
    out = _run(config, tiny.TRAIN, tiny.LIMITS_TRAIN, "train")
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] > out["checks"]["update_gap"]["limit"]


@pytest.mark.parametrize("config", [tiny.FX, tiny.VX], ids=["fx", "vx"])
def test_step_leaving_half_the_batch_out(monkeypatch, config):
    from gaot_torch.train import static_trainer as st

    inner = st.global_masked_mse

    def half(pred, target, sample_mask, *a, **k):
        keep = sample_mask.clone()
        keep[keep.shape[0] // 2:] = False
        return inner(pred, target, keep, *a, **k)

    monkeypatch.setattr(st, "global_masked_mse", half)
    out = _run(config, tiny.TRAIN, tiny.LIMITS_TRAIN, "train")
    assert not out["correct"]


def test_edge_drop_draws_that_do_not_advance(monkeypatch):
    """Every step draws its edge drop from the generator's state at the
    first step, as a captured step whose generator is not registered with
    its graph would replay the same draws."""
    from gaot_torch.train import static_trainer as st

    inner = st.step_update
    start = {}

    def frozen(model, optimizer, lr, graphs, coord, pndata, target, sample_mask,
               node_mask=None, condition=None, generator=None, mesh=None):
        state = start.setdefault("state", generator.get_state())
        generator.set_state(state)
        return inner(model, optimizer, lr, graphs, coord, pndata, target, sample_mask,
                     node_mask, condition, generator, mesh)

    monkeypatch.setattr(st, "step_update", frozen)
    out = _run(tiny.VX, tiny.TRAIN, tiny.LIMITS_TRAIN, "train")
    assert not out["correct"]
    for name in ("loss_gap", "step_loss_gap"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"]


def test_answer_altered_where_produced(monkeypatch):
    from gaot_torch.train import static_trainer as st

    inner = st.eval_step

    def altered(*a, **k):
        pred, loss = inner(*a, **k)
        pred = pred.clone()
        pred[0, 0] += 1.0
        return pred, loss

    monkeypatch.setattr(st, "eval_step", altered)
    out = _run(tiny.FX, tiny.INFER, tiny.LIMITS_INFER, "infer")
    assert not out["correct"]
