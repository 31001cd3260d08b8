"""Seconds the epoch path's capture took in set-up (warm-up steps, their
undo, the capture): ``train/graphed.py::CapturedStep.capture_s``."""
LAYER = "trainer loop"
UNIT = "s"
MOVES = "setup_s"
SOURCE = "program_span"


def read(r):
    return r.get("capture_s")
