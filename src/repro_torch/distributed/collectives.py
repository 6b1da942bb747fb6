"""Shard-axis exchanges of the sharded graph plane, in their stacked forms.

The one-device rendering keeps every shard's vectors and buckets in one
tensor with a leading shard axis, so each exchange is a reshape or a
reduction over that axis.  A rendering with one process per card runs the
same exchanges as collectives over ``torch.distributed``.
"""
from __future__ import annotations

import torch


def exchange_buckets(buckets: torch.Tensor) -> torch.Tensor:
    """The all-to-all of per-owner routing buckets: ``(n_src, n_owner,
    cap, ...)``, where row ``i`` holds what source shard ``i`` routed to
    each owner, becomes ``(n_owner, n_src, cap, ...)``: owner ``j``'s row
    holds what every source routed to it, in source order, so flattening
    it keeps the batch order."""
    return buckets.transpose(0, 1).contiguous()


def gather_interleaved(x_local: torch.Tensor, n_global: int) -> torch.Tensor:
    """``(n_shards, n_local)`` per-shard vertex vectors to the ``(V,)``
    global order: vertex ``v`` lives on shard ``v % S`` at local id
    ``v // S``, so the shard axis interleaves (the tail padding of the
    last local row is trimmed when ``V % S != 0``)."""
    return x_local.transpose(0, 1).reshape(-1)[:n_global]


def or_across_shards(partial_mask: torch.Tensor) -> torch.Tensor:
    """``(n_shards, B)`` partial boolean results (each batch position owned
    by one shard) to the full ``(B,)`` mask."""
    return partial_mask.any(dim=0)


__all__ = ["exchange_buckets", "gather_interleaved", "or_across_shards"]
