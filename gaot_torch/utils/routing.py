"""Kernel-route registry: which compute paths a run actually took.

The kernels are dispatched at call time from runtime predicates (device,
dtype, config — models/agno.py, models/transformer.py). Measurement
attribution needs the decisions on record, so every dispatch site calls
record_route() and a run prints format_routes() once (chip_smoke.py).

Config fields (model.args.transformer.fused_ffn,
model.args.transformer.attn_backend) choose the route.
"""
from __future__ import annotations

from typing import Dict

_ROUTES: Dict[str, str] = {}


def record_route(name: str, value: str) -> None:
    """Record the route a dispatch site took."""
    prev = _ROUTES.get(name)
    if prev is not None and prev != value:
        # Mixed routes within one run (e.g. fused AGNO on the decoder but
        # not the encoder's shapes) — keep both, they matter for attribution.
        value = prev if value in prev.split("+") else f"{prev}+{value}"
    _ROUTES[name] = value


def reset_routes() -> None:
    _ROUTES.clear()


def format_routes() -> str:
    if not _ROUTES:
        return "(none recorded)"
    return " ".join(f"{k}={v}" for k, v in sorted(_ROUTES.items()))
