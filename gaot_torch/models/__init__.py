from .gaot import GAOT

__all__ = ["GAOT"]
