"""Plain EmbeddingBag, from ``repro.kernels.embedding_bag.ref``: gather the
rows of every slot and take the masked, weighted sum over each bag."""
from __future__ import annotations

import torch


def embedding_bag_ref(indices: torch.Tensor, weights: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """indices (B, L) (-1 pads), weights (B, L) float32, table (N, D) ->
    (B, D) in the promoted dtype of table and weights (float32 for a
    bfloat16 table, as in the reference)."""
    ok = indices >= 0
    rows = table[torch.where(ok, indices, 0).long()]            # (B, L, D)
    rows = rows * torch.where(ok, weights, 0.0)[..., None]
    return rows.sum(dim=1)
