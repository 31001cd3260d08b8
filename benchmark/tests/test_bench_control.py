"""On the card, at each cell's own size: the control (the plain reference
computed in TF32, the precision below the configurations' float32, put in
the program's place) must fail a number of the cell's check on three seeds.
Marked ``cuda``: skips without a card."""
import pytest

from benchmark import harness

SEEDS = (11, 2 ** 31 + 3, 977)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_control_fails_the_check(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark.calibrate import control_context

    spec = harness.benchmark_spec()
    w = harness.cell_spec(spec, cell)
    mode = harness.mode_module(harness.traffic_file(w["traffic"])["mode"])
    limits = harness.limits_file(cell)
    for seed in SEEDS:
        numbers = mode.control(control_context(w, seed))
        assert any(v > limits[k] for k, v in numbers if k in limits), (seed, numbers, limits)
