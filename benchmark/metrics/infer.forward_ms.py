"""Device ms of a request's evaluation forward: CUDA events around each
``StaticTrainer._eval`` of the traced run's window, their mean."""
LAYER = "model forward"
UNIT = "ms"
MOVES = "infer_ms_p95"
SOURCE = "device_trace"


def read(r):
    return r.get("forward_ms") if r.get("mode") == "infer" else None
