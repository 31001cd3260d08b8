"""The share of the traced stretch (training epochs and their validation)
in which no operation ran on the device."""
LAYER = "device"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(r):
    if r.get("mode") != "train" or "trace" not in r:
        return None
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
