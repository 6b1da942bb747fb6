"""Shared helpers of the slab-update engine, and its whole-pool oracle.

``query_edges_ref``, ``insert_edges_ref`` and ``delete_edges_ref`` are the
reference's whole-pool forms (``repro.kernels.slab_update.ref``): plain
tensor code with per-bucket placement arrays, independent of the engine's
run-local planning and kernels, which must reproduce their pools bit for
bit.  They return a new graph and leave the one passed in as it was.

Semantics, as in the reference:

* A batch lane is valid iff ``src`` is a vertex (``0 <= src < n`` on the
  int32 bit pattern, which rejects the INVALID pad and every id at or above
  ``2**31``) and ``dst`` is not a key sentinel.  ``dst`` may be any other
  id: the sharded plane stores global ids in shard-local tables.
* Deletion flips found lanes to TOMBSTONE; the update plane never reuses a
  tombstoned lane.
* Placement sorts the batch stably on (bucket, dst), collapses duplicates,
  drains the free list from its top before the bump pointer, and sets the
  UpdateIterator state of a bucket at its first insert of the epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...core.hashing import (INVALID_SLAB, SLAB_WIDTH, TOMBSTONE_KEY,
                             bucket_hash, is_valid_vertex)
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


# ----------------------------------------------------------------------------
# the whole-pool oracle
# ----------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1


def sort_by_bucket(b: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable order by (bucket, dst as int32), invalid lanes last:
    ``(order, sorted bucket keys)``.  Two stable sorts, the minor key
    first, give the reference's ``lexsort``."""
    b_key = torch.where(valid, b, _INT32_MAX)
    by_dst = torch.sort(dst, stable=True).indices
    order = by_dst[torch.sort(b_key[by_dst], stable=True).indices]
    return order, b_key[order]


def _scatter_drop(t: torch.Tensor, idx: torch.Tensor, vals) -> None:
    """``t[idx] = vals`` in place, dropping indices outside ``t`` (the
    reference's ``.at[].set(mode="drop")``)."""
    keep = (idx >= 0) & (idx < t.shape[0])
    if isinstance(vals, torch.Tensor):
        vals = vals[keep]
    t[idx[keep].long()] = vals


def _sorted_batch(g: SlabGraph, src, dst):
    B = src.shape[0]
    valid = batch_valid(g, src, dst)
    order, b_s = sort_by_bucket(edge_buckets(g, src, dst, valid), dst, valid)
    dst_s, src_s, valid_s = dst[order], src[order], valid[order]
    same_prev = torch.zeros(B, dtype=torch.bool, device=src.device)
    if B > 1:
        same_prev[1:] = (b_s[1:] == b_s[:-1]) & (dst_s[1:] == dst_s[:-1])
    return order, b_s, src_s, dst_s, valid_s & ~same_prev


def _segment_count(mask: torch.Tensor, seg: torch.Tensor, n: int):
    """Per-segment count of ``mask`` over ``n`` segments (``seg`` = n for
    the dropped lanes)."""
    return torch.zeros(n + 1, dtype=torch.int32, device=mask.device) \
        .index_add_(0, seg.long(), mask.to(torch.int32))[:n]


def query_edges_ref(g: SlabGraph, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """Batched membership query."""
    valid = batch_valid(g, src, dst)
    found, _, _ = probe(g, edge_buckets(g, src, dst, valid), dst, valid)
    return found & valid


def insert_edges_ref(g: SlabGraph, src: torch.Tensor, dst: torch.Tensor,
                     w: Optional[torch.Tensor] = None
                     ) -> Tuple[SlabGraph, torch.Tensor]:
    """Batched ``InsertEdgeBatch``: (new graph, inserted mask).  The pool
    needs as many free slabs as the batch has lanes (``ensure_capacity``)."""
    B, W, S = src.shape[0], SLAB_WIDTH, g.capacity_slabs
    nb, dev = g.n_buckets, src.device
    order, b_s, src_s, dst_s, cand = _sorted_batch(g, src, dst)
    w_s = None if w is None else w[order]
    exists, _, _ = probe(g, torch.where(cand, b_s, 0), dst_s, cand)
    new = cand & ~exists
    new_i = new.to(torch.int32)

    # per-bucket counts, and each new edge's rank within its bucket's run
    counts = _segment_count(new, torch.where(new, b_s, nb), nb)
    excl = torch.cumsum(new_i, 0, dtype=torch.int32) - new_i
    run_start = torch.ones(B, dtype=torch.bool, device=dev)
    if B > 1:
        run_start[1:] = b_s[1:] != b_s[:-1]
    base = torch.cummax(torch.where(run_start, excl, -1), 0).values
    rank = torch.where(new, excl - base, 0)

    # placement: the tail's room, then new slabs, each bucket's in turn
    tail, fill = g.tail_slab, g.tail_fill
    room = W - fill
    overflow = (counts - room).clamp_min(0)
    new_slabs = (overflow + W - 1) // W
    cum = torch.cumsum(new_slabs, 0, dtype=torch.int32)
    ord_base = cum - new_slabs
    total_new = cum[-1]

    # the o-th new slab pops the free list (top first), then bumps
    k = torch.arange(B, dtype=torch.int32, device=dev)
    take = torch.minimum(total_new, g.free_top)
    recycled = g.free_list[(g.free_top - 1 - k).clamp(0, S - 1).long()]
    alloc_ids = torch.where(k < take, recycled, g.next_free + k - take)

    def slab_at(ordinal):
        return alloc_ids[ordinal.clamp(0, B - 1).long()]

    e_b = torch.where(new, b_s, 0).long()
    e_room = room[e_b]
    in_tail = rank < e_room
    over = rank - e_room
    e_slab = torch.where(in_tail, tail[e_b], slab_at(
        ord_base[e_b] + torch.div(over, W, rounding_mode="floor")))
    e_lane = torch.where(in_tail, fill[e_b] + rank, over % W)
    put = new & (e_slab >= 0) & (e_slab < S)
    keys = g.keys.clone()
    keys[e_slab[put].long(), e_lane[put].long()] = dst_s[put]
    weights = g.weights
    if weights is not None:
        wv = (torch.zeros(B, dtype=torch.float32, device=dev) if w_s is None
              else w_s.to(torch.float32))
        weights = weights.clone()
        weights[e_slab[put].long(), e_lane[put].long()] = wv[put]

    # chain the new slabs: an exhausted tail links to its bucket's first,
    # each to the next, a bucket's last ends the chain
    has_new = new_slabs > 0
    next_slab = g.next_slab.clone()
    _scatter_drop(next_slab, torch.where(has_new, tail, S), slab_at(ord_base))
    owner = torch.searchsorted(cum, k, right=True).clamp(0, nb - 1)
    is_last = k == (ord_base[owner] + new_slabs[owner] - 1)
    write_at = torch.where(k < total_new, alloc_ids, S)
    _scatter_drop(next_slab, write_at,
                  torch.where(is_last, INVALID_SLAB, slab_at(k + 1)))
    slab_vertex = g.slab_vertex.clone()
    _scatter_drop(slab_vertex, write_at, g.bucket_vertex[owner])
    slab_new = g.slab_new.clone()
    _scatter_drop(slab_new, write_at, True)

    # tails, and the UpdateIterator state at a bucket's first insert of the
    # epoch: the tail's first free lane, or lane 0 of its first new slab
    got = counts > 0
    first_time = got & ~g.upd_flag
    f_slab = torch.where(room > 0, tail, slab_at(ord_base))
    f_lane = torch.where(room > 0, fill, 0)

    inserted = torch.zeros(B, dtype=torch.bool, device=dev)
    inserted[order] = new
    g2 = dataclasses.replace(
        g, keys=keys, weights=weights, next_slab=next_slab,
        slab_vertex=slab_vertex,
        tail_slab=torch.where(has_new, slab_at(cum - 1), tail),
        tail_fill=torch.where(has_new, overflow - (new_slabs - 1) * W,
                              fill + counts),
        upd_flag=g.upd_flag | got,
        upd_slab=torch.where(first_time, f_slab, g.upd_slab),
        upd_lane=torch.where(first_time, f_lane, g.upd_lane),
        next_free=g.next_free + total_new - take,
        free_top=g.free_top - take, slab_new=slab_new,
        degree=g.degree + _segment_count(
            new, torch.where(new, src_s, g.n_vertices), g.n_vertices),
        n_edges=g.n_edges + new_i.sum(dtype=torch.int32))
    return g2, inserted


def delete_edges_ref(g: SlabGraph, src: torch.Tensor, dst: torch.Tensor
                     ) -> Tuple[SlabGraph, torch.Tensor]:
    """Batched ``DeleteEdgeBatch``: found lanes become TOMBSTONE (paper §6);
    (new graph, deleted mask)."""
    order, b_s, src_s, dst_s, cand = _sorted_batch(g, src, dst)
    found, slab, lane = probe(g, torch.where(cand, b_s, 0), dst_s, cand)
    hit = found & cand
    keys = g.keys.clone()
    keys[slab[hit].long(), lane[hit].long()] = TOMBSTONE_KEY
    deleted = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
    deleted[order] = hit
    g2 = dataclasses.replace(
        g, keys=keys,
        degree=g.degree - _segment_count(
            hit, torch.where(hit, src_s, g.n_vertices), g.n_vertices),
        n_edges=g.n_edges - hit.sum(dtype=torch.int32))
    return g2, deleted
