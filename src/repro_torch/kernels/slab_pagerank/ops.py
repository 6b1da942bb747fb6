"""Binding of PageRank's contribution sums onto the slab-sweep kernel.

Replaces ``slab_contrib_sums_pallas`` (``repro/kernels/slab_pagerank/
kernel.py:23``), which is the ``sum`` semiring of the sweep with no
frontier: the same CUDA kernel serves both.
"""
from __future__ import annotations

import torch

from ..slab_sweep.kernel import slab_sweep


def slab_contrib_sums(keys: torch.Tensor, slab_vertex: torch.Tensor,
                      contrib: torch.Tensor) -> torch.Tensor:
    """keys (S, 128) int32, slab_vertex (S,) int32, contrib (V,) float32
    -> (S,) float32 sums of contrib over each row's valid lanes."""
    return slab_sweep(keys, slab_vertex, contrib, semiring="sum",
                      n_vertices=contrib.numel())


def slab_contrib_sums_ref(keys: torch.Tensor, valid: torch.Tensor,
                          contrib: torch.Tensor) -> torch.Tensor:
    """Plain per-row sums of contrib over the lanes where ``valid`` is set."""
    idx = torch.where(valid, keys, 0).long()
    return torch.where(valid, contrib[idx], 0.0).sum(dim=1)
