"""Seconds of set-up spent in the host graph build: a span around each call
into ``data/graph_builder.py`` (search, padding, buckets, transpose graphs)
and ``prepare_fx_device_graphs``, summed."""
LAYER = "host graph build"
UNIT = "s"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(r):
    return r.get("graph_build_s")
