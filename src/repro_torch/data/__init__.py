"""Synthetic data made with numpy from a seed: RMAT edge lists, LM token
batches and recsys interaction batches."""
from .synth import lm_batches, recsys_batches, rmat_edges

__all__ = ["lm_batches", "recsys_batches", "rmat_edges"]
