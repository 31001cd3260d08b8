"""The neighbourhood multiply-reduce kernels' share of their roofline in
the traced stretch: the byte bound of every reduce it made (each step's
forward, d_f and d_coef of the encoder and the decoder, each validation
forward's; ``counts.py``) over the device seconds of the kernels named
below."""
from benchmark import trace

LAYER = "kernels: multiply-reduce"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
KERNELS = (r"mulred_k_kernel", r"mulred_b_kernel")


def read(r):
    if r.get("mode") != "train" or "trace" not in r:
        return None
    bound = (r["reduce_bound_s"] * r["steps"]
             + r["reduce_forward_bound_s"] * r["val_batches"])
    return 100.0 * bound / trace.kernel_seconds(r["trace"], KERNELS)
