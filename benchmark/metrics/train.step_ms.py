"""Device ms of a training step: CUDA events around each epoch's
``train_epoch`` (tables copied in, the steps replayed) in the traced
stretch, summed, over its steps."""
LAYER = "training step"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(r):
    return r.get("step_ms") if r.get("mode") == "train" else None
