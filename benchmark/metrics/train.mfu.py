"""The traced stretch's model operations (its training steps and its
validation forwards, ``counts.py``) over its seconds, as a share of the
card's product peak for the compute dtype (fp32: the TF32 peak)."""
from benchmark import counts

LAYER = "training step"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(r):
    if r.get("mode") != "train" or "trace" not in r:
        return None
    flops = r["step_flops"] * r["steps"] + r["forward_flops"] * r["val_batches"]
    return 100.0 * flops / r["trace"]["window_s"] / counts.peak_flops(r["shapes"].dtype)
