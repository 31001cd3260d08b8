"""The flash-attention kernels' share of their roofline in the traced
stretch: the bound of every attention call it made (each step's forward
with the LSE and backward, each validation forward; ``counts.py``) over
the device seconds of the kernels named below."""
from benchmark import trace

LAYER = "kernels: flash attention"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
KERNELS = (r"flash_fwd", r"flash_bwd")


def read(r):
    if r.get("mode") != "train" or "trace" not in r:
        return None
    bound = r["attn_bound_s"] * r["steps"] + r["attn_forward_bound_s"] * r["val_batches"]
    return 100.0 * bound / trace.kernel_seconds(r["trace"], KERNELS)
