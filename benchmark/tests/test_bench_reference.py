"""The plain reference against ``gaot_torch``'s plain route on the CPU at a
small size: the same weights loaded by the strict ``state_dict`` keys, the
same data; the predictions of the validation split, fx and vx (edge drop
plays no part in evaluation), and a whole run of the harness's training and
inference cells, whose checks compare losses, gradients and weight changes
(with vx edge drop drawn by both sides) and predictions."""
import time

import numpy as np
import pytest

from benchmark import run as bench_run
from benchmark.modes import train as train_mode
from benchmark.reference import train as ref_train
from benchmark.tests import tiny


def _ctx(config, seed=5):
    from benchmark import harness

    return bench_run.Context(config=config, traffic=tiny.TRAIN, device="cpu", seconds=0.5,
                             trace=False, seeds=harness.seeds(seed), folder=None)


@pytest.mark.parametrize("config", [tiny.FX, tiny.VX], ids=["fx", "vx"])
def test_predictions_match(config):
    import shutil

    ctx = _ctx(config)
    try:
        train_mode.build_program(ctx)
        tr = ctx.trainer
        batch = next(iter(tr.val_loader))
        pred = tr._eval(batch)[0].detach().numpy()
    finally:
        shutil.rmtree(ctx.folder, ignore_errors=True)
    ds = config["config"]["dataset"]
    rows = list(range(ds["train_size"], ds["train_size"] + ds["batch_size"]))
    prep = ref_train.prepare(ctx.arrays, config["config"], config["data"], "cpu")
    ref = ref_train.predict(ctx.w0, prep, rows, "cpu").numpy()
    n = ref.shape[1]
    pred = pred[:, :n]                     # a mesh's padded node rows dropped
    assert pred.shape == ref.shape
    np.testing.assert_allclose(pred, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def _run(config, traffic, limits, mode, seed):
    args = bench_run.parse(["--workload", "t", "--seed", str(seed), "--seconds", "0.5",
                            "--trace", "0"])
    return bench_run.run(args, spec=tiny.cell("t", "x", mode), device="cpu", config=config,
                         traffic=traffic, limits=limits, start=time.perf_counter())


@pytest.mark.parametrize("config,traffic,limits,mode", [
    (tiny.FX, tiny.TRAIN, tiny.LIMITS_TRAIN, "train"),
    (tiny.VX, tiny.TRAIN, tiny.LIMITS_TRAIN, "train"),
    (tiny.FX, tiny.INFER, tiny.LIMITS_INFER, "infer"),
], ids=["fx-train", "vx-train", "fx-infer"])
def test_harness_run_is_correct(config, traffic, limits, mode):
    import json

    rc, line = _run(config, traffic, limits, mode, seed=2 ** 31 + 17)
    assert rc == 0
    out = json.loads(line)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]
