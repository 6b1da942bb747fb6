"""Shared helpers of the slab-update engine and the probe's plain form.

Semantics, as in the reference (``repro.kernels.slab_update.ref``):

* A batch lane is valid iff ``src`` is a vertex (``0 <= src < n`` on the
  int32 bit pattern, which rejects the INVALID pad and every id at or above
  ``2**31``) and ``dst`` is not a key sentinel.  ``dst`` may be any other
  id: the sharded plane stores global ids in shard-local tables.
* Deletion flips found lanes to TOMBSTONE; the update plane never reuses a
  tombstoned lane.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.hashing import INVALID_SLAB, bucket_hash, is_valid_vertex
from ...core.slab_graph import SlabGraph
from .kernel import slab_probe_torch


def batch_valid(g: SlabGraph, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """Valid-lane mask: in-range src and non-sentinel dst."""
    return (src >= 0) & (src < g.n_vertices) & is_valid_vertex(dst)


def edge_buckets(g: SlabGraph, src: torch.Tensor, dst: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Global bucket of each (src, dst); 0 on invalid lanes."""
    s = torch.where(valid, src, 0).long()
    b = g.bucket_offset[s] + bucket_hash(dst, g.bucket_count[s])
    return torch.where(valid, b, 0).to(torch.int32)


def probe(g: SlabGraph, bucket: torch.Tensor, dst: torch.Tensor,
          valid: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk each valid query's chain; (found, slab, lane) per query."""
    start = torch.where(valid, bucket, INVALID_SLAB).to(torch.int32)
    return slab_probe_torch(g.keys, g.next_slab, start, dst)
