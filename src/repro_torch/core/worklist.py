"""Iteration primitives over the slab pool.

* ``pool_edges``      - SlabIterator over every vertex: the pool is one
  dense (S, 128) array and ``slab_vertex`` is its segment-id vector.
* ``expand_vertices`` - IterationScheme1 for a vertex set: walk the chains
  of the given vertices and emit their current out-edges, compacted by a
  prefix sum into a fixed-capacity edge buffer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .hashing import INVALID_SLAB, SLAB_WIDTH, is_valid_vertex
from .slab_graph import SlabGraph


class PoolView(NamedTuple):
    """Dense view of every adjacency entry in the pool."""
    src: torch.Tensor                # (S, 128) int32 owner per lane (-1 unalloc)
    dst: torch.Tensor                # (S, 128) int32 keys (sentinels included)
    weight: Optional[torch.Tensor]   # (S, 128) float32 or None
    valid: torch.Tensor              # (S, 128) bool, allocated real neighbour


def pool_edges(g: SlabGraph) -> PoolView:
    """SlabIterator over all vertices as one dense view (``src`` is a
    broadcast view, not a copy)."""
    src = g.slab_vertex[:, None].expand(g.capacity_slabs, SLAB_WIDTH)
    valid = (g.slab_vertex[:, None] >= 0) & is_valid_vertex(g.keys)
    return PoolView(src=src, dst=g.keys, weight=g.weights, valid=valid)


class EdgeFrontier(NamedTuple):
    src: torch.Tensor       # (cap,) int32
    dst: torch.Tensor       # (cap,) int32
    weight: torch.Tensor    # (cap,) float32 (zeros when unweighted)
    size: torch.Tensor      # () int32
    overflow: torch.Tensor  # () bool


def expand_vertices(g: SlabGraph, verts: torch.Tensor, vmask: torch.Tensor,
                    *, out_capacity: int, max_bpv: int = 1) -> EdgeFrontier:
    """Current out-edges of ``verts`` where ``vmask`` is set, in chain order.

    ``max_bpv`` must bound ``bucket_count`` (1 with hashing off).  Every hop
    reads one slab row per active bucket, like a warp advancing its
    SlabIterator; edges past ``out_capacity`` are dropped and flagged.
    """
    dev = g.device
    v = torch.where(vmask, verts, 0).long()
    j = torch.arange(max_bpv, dtype=torch.int32, device=dev)[None, :]
    bmask = (vmask[:, None] & (j < g.bucket_count[v][:, None])).reshape(-1)
    buckets = (g.bucket_offset[v][:, None] + j).reshape(-1)
    cur = torch.where(bmask, buckets, INVALID_SLAB).to(torch.int32)

    cap = out_capacity
    buf_src = torch.zeros(cap, dtype=torch.int32, device=dev)
    buf_dst = torch.zeros(cap, dtype=torch.int32, device=dev)
    buf_w = torch.zeros(cap, dtype=torch.float32, device=dev)
    size = torch.zeros((), dtype=torch.int32, device=dev)
    while bool((cur != INVALID_SLAB).any()):
        active = cur != INVALID_SLAB
        c = cur.clamp_min(0).long()
        rows = g.keys[c]
        flat = (active[:, None] & is_valid_vertex(rows)).reshape(-1)
        flat_i = flat.to(torch.int32)
        pos = size + torch.cumsum(flat_i, 0, dtype=torch.int32) - flat_i
        keep = flat & (pos < cap)
        at = pos[keep].long()
        buf_src[at] = g.slab_vertex[c][:, None].expand(rows.shape) \
            .reshape(-1)[keep]
        buf_dst[at] = rows.reshape(-1)[keep]
        if g.weights is not None:
            buf_w[at] = g.weights[c].reshape(-1)[keep]
        size = size + flat_i.sum(dtype=torch.int32)
        cur = torch.where(active, g.next_slab[c], INVALID_SLAB)
    return EdgeFrontier(src=buf_src, dst=buf_dst, weight=buf_w,
                        size=torch.clamp(size, max=cap), overflow=size > cap)
