"""The share of the traced stretch (requests back to back, each to its
prediction on the host) in which no operation ran on the device."""
LAYER = "device"
UNIT = "%"
MOVES = "infer_ms_p95"
SOURCE = "device_trace"


def read(r):
    if r.get("mode") != "infer" or "trace" not in r:
        return None
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
