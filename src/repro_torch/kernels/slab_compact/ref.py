"""Plain PyTorch oracle and shared helpers of slab compaction.

Compaction rebuilds a tombstone-riddled ``SlabGraph`` into the dense cold
layout of ``from_edges_host``: every bucket's surviving keys re-packed into
its head slab (row ``b``) and freshly numbered overflow slabs (from
``n_buckets`` up), chains relinked, tails, degrees and ``n_edges``
recounted, and the allocator reset (``free_top = 0``; the free slabs are
the suffix above ``next_free``).  Within a bucket the survivors keep
chain-walk order, the order a probe meets them.

``compact_ref`` is the sort-based oracle (``impl="oracle"``): it ranks
every ``(bucket, chain position, lane)`` triple of the pool with stable
sorts.  The engine (``ops.py``) builds the same pool leaf for leaf from
per-slab live counts and chain-prefix ranks, with no sort.

Shared helpers, the deterministic parts both paths agree on:

* ``live_lane_mask`` - the survivor mask: an allocated row's lane whose key,
  read as uint32, is below TOMBSTONE (the sharded plane stores global ids,
  so no ``< n_vertices`` bound applies);
* ``chain_order``    - the chain walk from every bucket head, giving each
  reached slab its bucket, chain position and live-lane base rank; it is
  the plain version of the chain-rank kernel;
* ``rebuild_links``  - the new head/overflow links and tails implied by the
  per-bucket survivor counts;
* ``perm_of``        - the old-to-new slab map for stale handles.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.hashing import (EMPTY_KEY, INVALID_SLAB, SLAB_WIDTH,
                             is_valid_vertex)
from ...core.slab_graph import SlabGraph

_INT32_MAX = 2 ** 31 - 1


def live_lane_mask(keys: torch.Tensor,
                   slab_vertex: torch.Tensor) -> torch.Tensor:
    """(S, 128) bool: allocated rows' lanes that hold a neighbour id."""
    return (slab_vertex >= 0)[:, None] & is_valid_vertex(keys)


def chain_order(next_slab: torch.Tensor, live_count: torch.Tensor,
                n_buckets: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """Walk every bucket's chain from its head (row ``b``).

    Returns per-slab ``(base_rank, bucket_of, chain_pos)``: the live lanes
    in earlier slabs of the chain, the owning bucket and the position along
    the chain (0, -1, -1 for rows no chain reaches), and the per-bucket
    survivor ``counts``.  One gather per hop over the chains still walking.
    """
    S, dev = next_slab.shape[0], next_slab.device
    base_rank = torch.zeros(S, dtype=torch.int32, device=dev)
    bucket_of = torch.full((S,), -1, dtype=torch.int32, device=dev)
    chain_pos = torch.full((S,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(n_buckets, dtype=torch.int32, device=dev)
    bucket = torch.arange(n_buckets, dtype=torch.int32, device=dev)
    cur = bucket.long()
    pos = 0
    while cur.numel():
        b = bucket.long()
        base_rank[cur] = counts[b]
        bucket_of[cur] = bucket
        chain_pos[cur] = pos
        counts[b] += live_count[cur]
        nxt = next_slab[cur]
        keep = nxt != INVALID_SLAB
        cur, bucket = nxt[keep].long(), bucket[keep]
        pos += 1
    return base_rank, bucket_of, chain_pos, counts


def rebuild_links(counts: torch.Tensor, *, n_buckets: int,
                  bucket_vertex: torch.Tensor, capacity: int):
    """The dense layout implied by per-bucket survivor counts.

    Bucket ``b`` keeps head row ``b``; its overflow slabs are the
    consecutive rows ``n_buckets + extra_off[b] ..``, as in
    ``from_edges_host``.  Returns ``(extra_off, total_slabs, next_slab,
    slab_vertex, tail_slab, tail_fill)``, everything but the lanes.
    """
    W, dev = SLAB_WIDTH, counts.device
    heads = torch.arange(n_buckets, dtype=torch.int32, device=dev)
    extra = ((counts + W - 1) // W - 1).clamp_min(0)
    extra_off = torch.cumsum(extra, 0, dtype=torch.int32) - extra
    total_extra = int(extra.sum())

    nxt = torch.full((capacity,), INVALID_SLAB, dtype=torch.int32,
                     device=dev)
    sv = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    sv[:n_buckets] = bucket_vertex
    has = extra > 0
    nxt[heads[has].long()] = n_buckets + extra_off[has]
    # overflow slab k (row n_buckets + k) belongs to the bucket whose
    # [extra_off, extra_off + extra) range holds k and links to row k + 1
    # unless it is that bucket's last
    owner = torch.repeat_interleave(heads.long(), extra.long(),
                                    output_size=total_extra)
    kk = torch.arange(total_extra, dtype=torch.int32, device=dev)
    ids = n_buckets + kk
    is_last = kk == extra_off[owner] + extra[owner] - 1
    nxt[ids.long()] = torch.where(is_last, INVALID_SLAB, ids + 1)
    sv[ids.long()] = bucket_vertex[owner]

    tail_slab = torch.where(has, n_buckets + extra_off + extra - 1, heads)
    tail_fill = counts - extra * W
    return (extra_off, n_buckets + total_extra, nxt, sv,
            tail_slab.to(torch.int32), tail_fill.to(torch.int32))


def slab_of_rank(rank: torch.Tensor, bucket: torch.Tensor,
                 extra_off: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """New row of a bucket's ``rank``-th survivor (head first, then the
    bucket's overflow run)."""
    b = bucket.clamp(0, n_buckets - 1).long()
    return torch.where(rank < SLAB_WIDTH, b,
                       n_buckets + extra_off[b] + rank // SLAB_WIDTH - 1)


def perm_of(base_rank, bucket_of, live_count, extra_off, *, n_buckets: int,
            capacity_old: int) -> torch.Tensor:
    """(S_old,) old-to-new slab map.  Heads stay in place; any other slab
    maps to the row its first survivor went to; slabs with no survivor and
    unreached rows map to INVALID_SLAB (a handle to them is dead)."""
    rows = torch.arange(capacity_old, dtype=torch.int32,
                        device=base_rank.device)
    moved = slab_of_rank(base_rank, bucket_of, extra_off, n_buckets)
    alive = (bucket_of >= 0) & (live_count > 0)
    return torch.where(rows < n_buckets, rows,
                       torch.where(alive, moved, INVALID_SLAB)
                       ).to(torch.int32)


def assemble(g: SlabGraph, *, capacity: int, counts, new_keys, new_weights,
             nxt, sv, tail_slab, tail_fill, total_slabs,
             degree) -> SlabGraph:
    """The rebuilt pools as a closed-epoch SlabGraph: the dense prefix in
    use, an empty free list, no slab new this epoch."""
    dev, nb = g.device, g.n_buckets
    total = torch.tensor(total_slabs, dtype=torch.int32, device=dev)
    return SlabGraph(
        keys=new_keys, weights=new_weights, next_slab=nxt, slab_vertex=sv,
        bucket_offset=g.bucket_offset, bucket_count=g.bucket_count,
        bucket_vertex=g.bucket_vertex,
        tail_slab=tail_slab, tail_fill=tail_fill,
        upd_flag=torch.zeros(nb, dtype=torch.bool, device=dev),
        # the engine writes the tails in place: the iterator state copies
        upd_slab=tail_slab.clone(), upd_lane=tail_fill.clone(),
        next_free=total, epoch_next_free=total.clone(),
        free_list=torch.full((capacity,), INVALID_SLAB, dtype=torch.int32,
                             device=dev),
        free_top=torch.zeros((), dtype=torch.int32, device=dev),
        slab_new=torch.zeros(capacity, dtype=torch.bool, device=dev),
        degree=degree, n_edges=counts.sum(dtype=torch.int32),
        n_vertices=g.n_vertices, n_buckets=nb, weighted=g.weighted)


def recount_degrees(g: SlabGraph, live_count: torch.Tensor) -> torch.Tensor:
    """(V,) stored-adjacency degrees recounted from the surviving lanes."""
    seg = torch.where(g.slab_vertex >= 0, g.slab_vertex, g.n_vertices).long()
    return torch.zeros(g.n_vertices + 1, dtype=torch.int32,
                       device=g.device).index_add_(
        0, seg, live_count.to(torch.int32))[:g.n_vertices]


# ----------------------------------------------------------------------------
# the oracle: sort-based whole-pool rebuild
# ----------------------------------------------------------------------------

def compact_ref(g: SlabGraph, *, capacity_slabs: int
                ) -> Tuple[SlabGraph, torch.Tensor]:
    """Bit-exact reference compaction: every lane triple ``(bucket,
    chain_pos, lane)`` ranked by stable sorts (lane, then position, then
    bucket: the reference's lexsort), dead lanes last; survivors scatter
    into the new pool.  Returns ``(compacted graph, old-to-new perm)``.
    Does not modify ``g``."""
    W, S, nb, dev = SLAB_WIDTH, g.capacity_slabs, g.n_buckets, g.device
    live = live_lane_mask(g.keys, g.slab_vertex)
    live_cnt = live.sum(dim=1, dtype=torch.int32)
    base_rank, bucket_of, chain_pos, counts = chain_order(
        g.next_slab, live_cnt, nb)
    extra_off, total_slabs, nxt, sv, tail_slab, tail_fill = rebuild_links(
        counts, n_buckets=nb, bucket_vertex=g.bucket_vertex,
        capacity=capacity_slabs)

    flat_live = live.reshape(-1)
    b_key = torch.where(flat_live, bucket_of.repeat_interleave(W),
                        _INT32_MAX)
    p_key = torch.where(flat_live, chain_pos.repeat_interleave(W),
                        _INT32_MAX)
    l_key = torch.arange(W, dtype=torch.int32, device=dev).repeat(S)
    order = torch.sort(l_key, stable=True).indices
    order = order[torch.sort(p_key[order], stable=True).indices]
    order = order[torch.sort(b_key[order], stable=True).indices]
    b_s = b_key[order]

    # rank within the sorted bucket runs
    n = S * W
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    run_start = torch.ones(n, dtype=torch.bool, device=dev)
    run_start[1:] = b_s[1:] != b_s[:-1]
    rank = idx - torch.cummax(torch.where(run_start, idx, -1), 0).values

    srv = b_s < _INT32_MAX
    dst = (slab_of_rank(rank[srv], b_s[srv], extra_off, nb) * W
           + rank[srv] % W)
    src = order[srv]
    new_keys = torch.full((capacity_slabs, W), EMPTY_KEY, dtype=torch.int32,
                          device=dev)
    new_keys.view(-1)[dst] = g.keys.reshape(-1)[src]
    new_weights = None
    if g.weighted:
        new_weights = torch.zeros((capacity_slabs, W), dtype=torch.float32,
                                  device=dev)
        new_weights.view(-1)[dst] = g.weights.reshape(-1)[src]

    g2 = assemble(g, capacity=capacity_slabs, counts=counts,
                  new_keys=new_keys, new_weights=new_weights, nxt=nxt, sv=sv,
                  tail_slab=tail_slab, tail_fill=tail_fill,
                  total_slabs=total_slabs,
                  degree=recount_degrees(g, live_cnt))
    perm = perm_of(base_rank, bucket_of, live_cnt, extra_off, n_buckets=nb,
                   capacity_old=S)
    return g2, perm
