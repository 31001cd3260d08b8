"""The flash-attention forward kernels' share of their roofline in the
traced stretch: the bound of every forward attention call
(``counts.py``) over the device seconds of the kernels named below."""
from benchmark import trace

LAYER = "kernels: flash attention"
UNIT = "%"
MOVES = "infer_samples_per_s"
SOURCE = "device_trace"
KERNELS = (r"flash_fwd",)


def read(r):
    if r.get("mode") != "infer" or "trace" not in r:
        return None
    bound = r["attn_forward_bound_s"] * r["requests"]
    return 100.0 * bound / trace.kernel_seconds(r["trace"], KERNELS)
