from .linear import linear

__all__ = ["linear"]
