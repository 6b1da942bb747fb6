"""Plain PyTorch oracle of the slab_pagerank pool sweep, from
``repro.kernels.slab_pagerank.ref``: every lane of every row is read."""
from __future__ import annotations

import torch


def slab_contrib_sums_ref(keys: torch.Tensor, slab_vertex: torch.Tensor,
                          contrib: torch.Tensor, *,
                          n_vertices: int) -> torch.Tensor:
    """keys (S, 128) int32 bit patterns, slab_vertex (S,) int32, contrib
    (V,) float32 -> (S,) float32."""
    valid = (keys >= 0) & (keys < n_vertices) & (slab_vertex[:, None] >= 0)
    idx = torch.where(valid, keys, 0).long()
    vals = torch.where(valid, contrib[idx], 0.0)
    return vals.sum(dim=1)
