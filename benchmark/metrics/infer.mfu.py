"""The traced stretch's forward operations (``counts.py``) over its seconds,
as a share of the card's product peak for the compute dtype (fp32: the TF32
peak)."""
from benchmark import counts

LAYER = "model forward"
UNIT = "%"
MOVES = "infer_samples_per_s"
SOURCE = "host_clock"


def read(r):
    if r.get("mode") != "infer" or "trace" not in r:
        return None
    flops = r["forward_flops"] * r["requests"]
    return 100.0 * flops / r["trace"]["window_s"] / counts.peak_flops(r["shapes"].dtype)
