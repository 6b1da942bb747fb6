"""Synthetic data made with numpy from a seed: RMAT and uniform edge lists,
padded edge batches, LM token batches and recsys interaction batches; and
the k-hop fanout sampler over a CSR snapshot (``sampler``)."""
from .synth import (edge_batches, lm_batches, recsys_batches, rmat_edges,
                    uniform_edges)

__all__ = ["edge_batches", "lm_batches", "recsys_batches", "rmat_edges",
           "uniform_edges"]
