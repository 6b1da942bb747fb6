"""Synthetic data: RMAT edge lists made with numpy from a seed."""
from .synth import rmat_edges

__all__ = ["rmat_edges"]
