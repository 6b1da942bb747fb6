"""The public EmbeddingBag op, from ``repro.kernels.embedding_bag.ops``.

``impl="auto"`` launches the hand-written kernel for CUDA tensors and runs
the plain ``embedding_bag_ref`` for CPU tensors.  Either way the result has
the table's dtype, as the reference's kernel path gives it.  Nothing in the
port calls it yet, as nothing in the reference does: MIND gathers its
history rows itself.
"""
from __future__ import annotations

import torch

from ...core.device import resolve_impl
from .kernel import embedding_bag_cuda
from .ref import embedding_bag_ref


def embedding_bag(indices: torch.Tensor, weights: torch.Tensor,
                  table: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Per bag, the sum over its non-pad slots of weight * table row:
    indices (B, L) int32 (-1 pads), weights (B, L) float32, table (N, D)
    -> (B, D) in the table's dtype, accumulated in float32."""
    if resolve_impl(impl, table) == "torch":
        return embedding_bag_ref(indices, weights, table).to(table.dtype)
    return embedding_bag_cuda(indices, weights, table)
