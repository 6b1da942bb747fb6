"""Iteration primitives over the slab pool (paper §3.4, Tables 1-3).

* ``pool_edges``        - SlabIterator over every vertex: the pool is one
  dense (S, 128) array and ``slab_vertex`` is its segment-id vector.
* ``updated_lane_mask`` - UpdateIterator as a lane mask: the entries
  inserted since the last ``update_slab_pointers``.
* ``updated_edges``     - UpdateIterator as a walk: only the flagged
  buckets' chains, from each one's first new lane.
* ``updated_vertices``  - the per-vertex update flag of the SlabIterator
  incremental scheme.
* ``expand_vertices``   - IterationScheme1 for a vertex set: walk the chains
  of the given vertices and emit their current out-edges, compacted by a
  prefix sum into a fixed-capacity edge buffer.
* ``csr_snapshot``      - the current adjacency frozen into CSR.
* ``transpose_host``    - the in-edge (or symmetric) graph, built on the host.
* ``occupancy_stats``   - slab occupancy and the representation's bytes.

The reference's ``while_loop``s are Python loops here; each hop asks the
host whether any chain is still being walked.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .hashing import INVALID_SLAB, SLAB_WIDTH, is_valid_vertex
from .slab_graph import SlabGraph, from_edges_host


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


def updated_lane_mask(g: SlabGraph) -> torch.Tensor:
    """(S, 128) bool: the lanes holding edges inserted in the open epoch.

    Rule 1: a slab allocated this epoch (``slab_new``) is wholly new; a row
    compare against ``epoch_next_free`` is not enough, since the free list
    hands out reclaimed slabs below that watermark.  Rule 2: a flagged
    bucket's ``upd_slab`` is new from ``upd_lane`` on.  Later slabs of a
    flagged chain fall under rule 1, since inserts append at the tail.
    """
    S = g.capacity_slabs
    start = torch.where(g.slab_new, 0, SLAB_WIDTH).to(torch.int32)
    flagged = g.upd_flag & ~g.slab_new[g.upd_slab.long()]
    # unflagged buckets land in a scratch row S, as the reference's
    # mode="drop" scatter drops them
    tgt = torch.where(flagged, g.upd_slab, S).long()
    lane0 = torch.where(flagged, g.upd_lane, SLAB_WIDTH).to(torch.int32)
    start = torch.cat([start, start.new_full((1,), SLAB_WIDTH)]) \
        .scatter_reduce_(0, tgt, lane0, "amin", include_self=True)[:S]
    lane = torch.arange(SLAB_WIDTH, dtype=torch.int32, device=g.device)
    mask = lane[None, :] >= start[:, None]
    return mask & (g.slab_vertex[:, None] >= 0) & is_valid_vertex(g.keys)


def updated_edges(g: SlabGraph, *, max_buckets: int,
                  out_capacity: int) -> "EdgeFrontier":
    """UpdateIterator traversal in O(updated slabs), not O(pool).

    The flagged buckets, in bucket order and at most ``max_buckets`` of
    them, are walked from their (``upd_slab``, ``upd_lane``) on: the first
    slab from its stored lane (Fig. 2), every later one whole.  Edges come
    hop by hop, buckets in id order within a hop; past ``out_capacity``
    they are dropped and ``overflow`` is set.
    """
    # the reference pads the bucket list to max_buckets with ended chains,
    # which emit nothing
    bids = torch.nonzero(g.upd_flag).reshape(-1)[:max_buckets]
    return _walk_chains(g, g.upd_slab[bids], out_capacity, g.upd_lane[bids])


def updated_vertices(g: SlabGraph) -> torch.Tensor:
    """(V,) bool: the vertex has a flagged bucket (the per-vertex
    ``is_updated`` flag of the SlabIterator scheme, paper §6.4.2)."""
    per_vertex = torch.zeros(g.n_vertices, dtype=torch.int32,
                             device=g.device).scatter_reduce_(
        0, g.bucket_vertex.long(), g.upd_flag.to(torch.int32), "amax",
        include_self=True)
    return per_vertex > 0


class EdgeFrontier(NamedTuple):
    src: torch.Tensor       # (cap,) int32
    dst: torch.Tensor       # (cap,) int32
    weight: torch.Tensor    # (cap,) float32 (zeros when unweighted)
    size: torch.Tensor      # () int32
    overflow: torch.Tensor  # () bool


def _walk_chains(g: SlabGraph, cur: torch.Tensor, cap: int,
                 lane_min: Optional[torch.Tensor] = None) -> EdgeFrontier:
    """Walk the chains from the slabs ``cur`` (INVALID_SLAB: none) in lock
    step, one row a chain a hop, like warps advancing their iterators; emit
    each row's live keys hop by hop, chains in order within a hop, into
    ``cap``-edge buffers, dropping and flagging edges past ``cap``.  On the
    first hop only lanes at or past ``lane_min`` emit."""
    dev = g.device
    buf_src = torch.zeros(cap, dtype=torch.int32, device=dev)
    buf_dst = torch.zeros(cap, dtype=torch.int32, device=dev)
    buf_w = torch.zeros(cap, dtype=torch.float32, device=dev)
    size = torch.zeros((), dtype=torch.int32, device=dev)
    lane = torch.arange(SLAB_WIDTH, dtype=torch.int32, device=dev)
    while bool((cur != INVALID_SLAB).any()):
        active = cur != INVALID_SLAB
        c = cur.clamp_min(0).long()
        rows = g.keys[c]
        emit = active[:, None] & is_valid_vertex(rows)
        if lane_min is not None:
            emit &= lane[None, :] >= lane_min[:, None]
            lane_min = None                 # later slabs are wholly new
        flat = emit.reshape(-1)
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


def expand_vertices(g: SlabGraph, verts: torch.Tensor, vmask: torch.Tensor,
                    *, out_capacity: int, max_bpv: int = 1) -> EdgeFrontier:
    """Current out-edges of ``verts`` where ``vmask`` is set, in chain order.

    ``max_bpv`` must bound ``bucket_count`` (1 with hashing off): buckets
    past it are not walked.  Edges past ``out_capacity`` are dropped and
    flagged.
    """
    dev = g.device
    v = torch.where(vmask, verts, 0).long()
    j = torch.arange(max_bpv, dtype=torch.int32, device=dev)[None, :]
    bmask = (vmask[:, None] & (j < g.bucket_count[v][:, None])).reshape(-1)
    buckets = (g.bucket_offset[v][:, None] + j).reshape(-1)
    cur = torch.where(bmask, buckets, INVALID_SLAB).to(torch.int32)

    return _walk_chains(g, cur, out_capacity)


class CSR(NamedTuple):
    indptr: torch.Tensor             # (V+1,) int32
    indices: torch.Tensor            # (E_cap,) int32, padded with -1
    weights: Optional[torch.Tensor]  # (E_cap,) float32, padded with 0
    n_edges: torch.Tensor            # () int32


def csr_snapshot(g: SlabGraph, *, max_edges: int) -> CSR:
    """The current adjacency frozen into CSR, rows by source vertex.

    Within a row the edges keep pool order, as the reference's stable sort
    on the owner gives them.  ``indices`` has ``min(max_edges, S * 128)``
    entries, -1 past the live edge count.
    """
    dev = g.device
    view = pool_edges(g)
    src = view.src[view.valid]               # live lanes in pool order
    order = torch.sort(src, stable=True).indices
    n_e = src.numel()
    counts = torch.bincount(src.long(), minlength=g.n_vertices)
    indptr = torch.zeros(g.n_vertices + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    take = min(max_edges, g.capacity_slabs * SLAB_WIDTH)
    n = min(n_e, take)
    indices = torch.full((take,), -1, dtype=torch.int32, device=dev)
    indices[:n] = view.dst[view.valid][order[:n]]
    w = None
    if view.weight is not None:
        w = torch.zeros(take, dtype=torch.float32, device=dev)
        w[:n] = view.weight[view.valid][order[:n]]
    return CSR(indptr=indptr, indices=indices, weights=w,
               n_edges=torch.tensor(n_e, dtype=torch.int32, device=dev))


def transpose_host(g: SlabGraph, *, symmetric: bool = False,
                   hashing: bool = False, load_factor: float = 0.7,
                   slack_slabs: int = 0, device="cuda") -> SlabGraph:
    """The in-edge graph of ``g`` (owner = dst, lane keys = src, weights
    carried along), built on the host with numpy and moved to ``device``
    (``cuda`` unless ``device="cpu"``).  ``symmetric=True`` keeps both
    directions (the undirected view of WCC label propagation).  The sweep
    reduces into the slab owner, so push-style relaxations sweep this
    view."""
    view = pool_edges(g)
    valid = view.valid.cpu().numpy()
    src = view.src.cpu().numpy()[valid]
    dst = view.dst.cpu().numpy()[valid]
    w = view.weight.cpu().numpy()[valid] if g.weights is not None else None
    kw = dict(hashing=hashing, load_factor=load_factor,
              slack_slabs=slack_slabs, device=device)
    if symmetric:
        return from_edges_host(
            g.n_vertices, np.concatenate([src, dst]),
            np.concatenate([dst, src]),
            None if w is None else np.concatenate([w, w]), **kw)
    return from_edges_host(g.n_vertices, dst, src, w, **kw)


def occupancy_stats(g: SlabGraph) -> dict:
    """Slab occupancy and allocation (the memory table, paper §6.1)."""
    n_alloc = int((g.slab_vertex >= 0).sum())
    used_lanes = int(pool_edges(g).valid.sum())
    return {
        "allocated_slabs": n_alloc,
        "capacity_slabs": g.capacity_slabs,
        "used_lanes": used_lanes,
        "occupancy": float(used_lanes) / float(max(1, n_alloc) * SLAB_WIDTH),
        "pool_bytes": int(g.keys.numel() * 4 + (
            g.weights.numel() * 4 if g.weights is not None else 0)),
        "repr_bytes": g.nbytes(),
    }
