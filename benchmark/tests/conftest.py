"""Tests of the benchmark (``python -m pytest benchmark/tests``). Tests marked
``cuda`` need an NVIDIA card and skip elsewhere (each decides inside itself);
run them on the card with ``python -m pytest benchmark/tests -m cuda``."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips elsewhere")
