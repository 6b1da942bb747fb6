"""Meerkat's iterator API (paper Tables 1-3) for one vertex.

The pool-wide forms live in ``worklist`` (pool sweeps, frontier
expansion); these are the per-vertex iterators of the paper's API:
``bucket_iterator`` walks one slab list of a vertex (BucketIterator),
``slab_iterator`` every slab list of it (SlabIterator), ``update_iterator``
only the lanes inserted this epoch (UpdateIterator).  Each returns the
visited neighbour ids as ``(neighbors[max_neighbors], count)``: int32 key
bit patterns, EMPTY (-2) past ``count``, and ``count`` a 0-d int32 tensor.
A chain walk asks the host for the next slab at every hop.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .hashing import EMPTY_KEY, INVALID_SLAB, is_valid_vertex
from .slab_graph import SlabGraph
from .worklist import updated_lane_mask


def _empty_buffer(g: SlabGraph, max_neighbors: int) -> torch.Tensor:
    return torch.full((max_neighbors,), EMPTY_KEY, dtype=torch.int32,
                      device=g.device)


def bucket_iterator(g: SlabGraph, v, bucket_index, *, max_neighbors: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``begin_at(i)``/``end_at(i)``: the neighbours in vertex ``v``'s
    ``bucket_index``-th slab list, in chain order; the count stops at
    ``max_neighbors``."""
    buf = _empty_buffer(g, max_neighbors)
    n = torch.zeros((), dtype=torch.int32, device=g.device)
    cur = int(g.bucket_offset[int(v)]) + int(bucket_index)
    while cur != INVALID_SLAB:
        row = g.keys[cur]
        ok = is_valid_vertex(row)
        m = ok.to(torch.int32)
        pos = n + torch.cumsum(m, 0, dtype=torch.int32) - m
        keep = ok & (pos < max_neighbors)
        buf[pos[keep].long()] = row[keep]
        n = n + m.sum(dtype=torch.int32)
        cur = int(g.next_slab[cur])
    return buf, torch.clamp(n, max=max_neighbors)


def slab_iterator(g: SlabGraph, v, *, max_neighbors: int,
                  max_bpv: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``begin()``/``end()``: every current neighbour of ``v``, one slab list
    at a time, over its first ``max_bpv`` buckets.  Each list's count is
    clipped to ``max_neighbors`` before it is added, as in the reference.

    The reference also walks the buckets from ``bucket_count[v]`` to
    ``max_bpv`` (reading whatever bucket follows ``v``'s, or a clamped one
    past the pool's last) and masks them out; they add nothing, so they are
    not walked here.
    """
    buf = _empty_buffer(g, max_neighbors)
    n = torch.zeros((), dtype=torch.int32, device=g.device)
    take = torch.arange(max_neighbors, dtype=torch.int32, device=g.device)
    for i in range(min(max_bpv, int(g.bucket_count[int(v)]))):
        nb, cnt = bucket_iterator(g, v, i, max_neighbors=max_neighbors)
        pos = n + take
        keep = (take < cnt) & (pos < max_neighbors)
        buf[pos[keep].long()] = nb[keep]
        n = n + cnt
    return buf, torch.clamp(n, max=max_neighbors)


def update_iterator(g: SlabGraph, v, *, max_neighbors: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``update_begin()``/``update_end()``: only the neighbours of ``v``
    inserted this epoch, in pool order."""
    mine = updated_lane_mask(g) & (g.slab_vertex[:, None] == int(v))
    new = g.keys[mine]
    k = min(new.numel(), max_neighbors)
    buf = _empty_buffer(g, max_neighbors)
    buf[:k] = new[:k]
    return buf, torch.tensor(k, dtype=torch.int32, device=g.device)
