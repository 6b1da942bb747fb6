"""The slab-update engine: batched insert, delete and query on a SlabGraph.

A port of the reference engine (``repro.kernels.slab_update.ops``), which
reproduces its whole-pool oracle bit for bit:

1. **Classify.**  Hash every lane to its global bucket, sort the batch
   stably on (bucket, dst) with invalid lanes last, collapse duplicates,
   and probe each candidate's chain (the probe kernel).
2. **Run-local placement.**  Inserts are planned over the sorted batch's
   runs, one per touched bucket, so planning is O(batch log batch): room in
   the tail slab, overflow, new slabs drawn from the free list before the
   bump pointer.
3. **Commit.**  Keys, weights and degree deltas go into the pool through the
   commit kernel.  The reference made its commit kernel opt-in because the
   TPU runs it as a serial loop; on the GPU it is a parallel scatter, so
   every commit runs through it.

The engine mutates the graph's tensors in place (the reference donates its
buffers for the same effect): a graph passed in is consumed, and the caller
threads the graph that comes back.  Batches are (B,) int32 tensors of key
bit patterns on the graph's device, padded with INVALID_VERTEX (-1).

``impl`` follows the tensors (``core.device.resolve_impl``): the kernels on
CUDA, their plain versions on the CPU.

The stacked shard plane (``update_shards``, ``query_shards``) takes a
graph whose tensor fields carry a leading shard axis and runs the
per-graph engine on each shard's views in turn (``core.slab_graph.
shard_view``), so the in-place commits land in the stacked pools; the
``*_local`` names are the uninstrumented per-graph bodies they run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.device import IMPLS, resolve_impl
from ...core.hashing import INVALID_SLAB, INVALID_VERTEX, SLAB_WIDTH, \
    TOMBSTONE_KEY
from ...core.slab_graph import SlabGraph, shard_view, write_back
from ...obs.instrument import timed_dispatch
from .kernel import slab_commit, slab_probe
from .ref import (_INT32_MAX, _scatter_drop, batch_valid, delete_edges_ref,
                  edge_buckets, insert_edges_ref, probe, query_edges_ref)

FORWARD = "forward"
TRANSPOSE = "transpose"
SYMMETRIC = "symmetric"

_INT32_MIN = -2 ** 31


def _classify(g: SlabGraph, src, dst):
    """Hash, one stable sort on (bucket, dst) with pads last, dup-collapse,
    then the chain-walk probe, all on the sorted batch."""
    B = src.shape[0]
    valid = batch_valid(g, src, dst)
    b_key = torch.where(valid, edge_buckets(g, src, dst, valid), _INT32_MAX)
    # (bucket, dst as int32) as one int64 key; the +2**31 keeps the signed
    # order of dst, as the reference's sort on dst.astype(int32) does
    comp = (b_key.long() << 32) | (dst.long() + 2 ** 31)
    order = torch.sort(comp, stable=True).indices
    b_s, dst_s, src_s, valid_s = b_key[order], dst[order], src[order], \
        valid[order]
    same_prev = torch.zeros(B, dtype=torch.bool, device=src.device)
    if B > 1:
        same_prev[1:] = (b_s[1:] == b_s[:-1]) & (dst_s[1:] == dst_s[:-1])
    cand = valid_s & ~same_prev
    start = torch.where(cand, b_s, INVALID_SLAB)
    found, slab, lane = slab_probe(g.keys, g.next_slab, start, dst_s)
    return order, b_s, src_s, dst_s, cand, found, slab, lane


# ----------------------------------------------------------------------------
# engine bodies
# ----------------------------------------------------------------------------

@timed_dispatch("slab_update")
def query_edges(g: SlabGraph, src: torch.Tensor, dst: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """Batched membership query; invalid lanes (out-of-range src, sentinel
    dst) answer False."""
    resolve_impl(impl, g.keys)
    valid = batch_valid(g, src, dst)
    start = torch.where(valid, edge_buckets(g, src, dst, valid),
                        INVALID_SLAB)
    found, _, _ = slab_probe(g.keys, g.next_slab, start, dst)
    return found & valid


@timed_dispatch("slab_update")
def insert_edges(g: SlabGraph, src: torch.Tensor, dst: torch.Tensor,
                 w: Optional[torch.Tensor] = None, *, impl: str = "auto"
                 ) -> Tuple[SlabGraph, torch.Tensor]:
    """Batched insert; returns (graph, inserted mask over the batch).

    Existing edges and in-batch duplicates are rejected; new edges append
    at their bucket's tail, opening slabs from the free list, then the bump
    pointer.  Consumes ``g`` (in-place commit).
    """
    resolve_impl(impl, g.keys)
    dev = g.device
    B, W, nb, cap = src.shape[0], SLAB_WIDTH, g.n_buckets, g.capacity_slabs
    order, b_s, src_s, dst_s, cand, exists, _, _ = _classify(g, src, dst)
    w_s = None if w is None else w[order]
    new = cand & ~exists
    new_i = new.to(torch.int32)

    # rank of each new edge within its bucket's run
    excl = torch.cumsum(new_i, 0, dtype=torch.int32) - new_i
    run_start = torch.ones(B, dtype=torch.bool, device=dev)
    if B > 1:
        run_start[1:] = b_s[1:] != b_s[:-1]
    base = torch.cummax(torch.where(run_start, excl, -1), 0).values
    rank = torch.where(new, excl - base, 0)

    # run-local plan: one run per touched bucket, at most B runs
    run_id = (torch.cumsum(run_start.to(torch.int32), 0, dtype=torch.int32)
              - 1).long()
    count_r = torch.zeros(B, dtype=torch.int32, device=dev).index_add_(
        0, run_id, new_i)
    # empty runs keep INT32_MIN, as segment_max leaves them
    bucket_r = torch.full((B,), _INT32_MIN, dtype=torch.int32,
                          device=dev).scatter_reduce_(
        0, run_id, b_s, "amax", include_self=True)
    run_ok = (bucket_r >= 0) & (bucket_r < _INT32_MAX)
    b_safe_r = torch.where(run_ok, bucket_r, 0).long()
    tail_r = g.tail_slab[b_safe_r]
    fill_r = g.tail_fill[b_safe_r]
    room_r = W - fill_r
    overflow_r = (count_r - room_r).clamp_min(0)
    new_slabs_r = (overflow_r + W - 1) // W
    cum_r = torch.cumsum(new_slabs_r, 0, dtype=torch.int32)
    total_new = cum_r[-1]

    # allocation: drain the free list from its top, then bump
    k = torch.arange(B, dtype=torch.int32, device=dev)
    take = torch.minimum(total_new, g.free_top)
    recycled = g.free_list[(g.free_top - 1 - k).clamp(0, cap - 1).long()]
    alloc_ids = torch.where(k < take, recycled, g.next_free + k - take)
    ord_base_r = cum_r - new_slabs_r

    def slab_at(ordinal):
        return alloc_ids[ordinal.clamp(0, B - 1).long()]

    e_room = room_r[run_id]
    in_tail = rank < e_room
    over = rank - e_room
    e_slab = torch.where(in_tail, tail_r[run_id],
                         slab_at(ord_base_r[run_id]
                                 + torch.div(over, W, rounding_mode="floor")))
    e_lane = torch.where(in_tail, fill_r[run_id] + rank, over % W)
    e_slab = torch.where(new, e_slab, cap)             # parked: dropped
    e_lane = torch.where(new, e_lane, 0)

    # gathers from the bucket state happen before any of it is written
    got_r = count_r > 0
    first_r = got_r & ~g.upd_flag[b_safe_r]
    has_new_r = new_slabs_r > 0
    new_tail_r = torch.where(has_new_r, slab_at(cum_r - 1), tail_r)
    new_fill_r = torch.where(has_new_r, overflow_r - (new_slabs_r - 1) * W,
                             fill_r + count_r)
    f_slab_r = torch.where(room_r > 0, tail_r, slab_at(ord_base_r))
    f_lane_r = torch.where(room_r > 0, fill_r, 0)
    owner = torch.searchsorted(cum_r, k, right=True).clamp(0, B - 1)
    is_last = k == (ord_base_r[owner] + new_slabs_r[owner] - 1)
    new_owner = g.bucket_vertex[b_safe_r[owner]]

    deg_idx = torch.where(new, src_s, g.n_vertices)
    slab_commit(g.keys, g.degree, g.weights, e_slab, e_lane, dst_s, deg_idx,
                torch.ones(B, dtype=torch.int32, device=dev),
                None if (w_s is None or g.weights is None)
                else w_s.to(torch.float32).contiguous())

    # chain the fresh slabs: the old tail links to the run's first new slab,
    # each new slab to the next, the run's last ends the chain
    _scatter_drop(g.next_slab, torch.where(has_new_r, tail_r, cap),
                  slab_at(ord_base_r))
    write_at = torch.where(k < total_new, alloc_ids, cap)
    _scatter_drop(g.next_slab, write_at,
                  torch.where(is_last, INVALID_SLAB, slab_at(k + 1)))
    _scatter_drop(g.slab_vertex, write_at, new_owner)
    _scatter_drop(g.slab_new, write_at, True)

    # tails and UpdateIterator state, at the touched buckets only
    _scatter_drop(g.tail_slab, torch.where(run_ok, bucket_r, nb), new_tail_r)
    _scatter_drop(g.tail_fill, torch.where(run_ok, bucket_r, nb), new_fill_r)
    _scatter_drop(g.upd_flag, torch.where(got_r, bucket_r, nb), True)
    _scatter_drop(g.upd_slab, torch.where(first_r, bucket_r, nb), f_slab_r)
    _scatter_drop(g.upd_lane, torch.where(first_r, bucket_r, nb), f_lane_r)

    inserted = torch.zeros(B, dtype=torch.bool, device=dev)
    inserted[order] = new
    g.next_free = g.next_free + total_new - take
    g.free_top = g.free_top - take
    g.n_edges = g.n_edges + new_i.sum(dtype=torch.int32)
    return g, inserted


@timed_dispatch("slab_update")
def delete_edges(g: SlabGraph, src: torch.Tensor, dst: torch.Tensor, *,
                 impl: str = "auto") -> Tuple[SlabGraph, torch.Tensor]:
    """Batched delete (found lanes become TOMBSTONE); returns (graph,
    deleted mask).  Consumes ``g`` (in-place commit)."""
    resolve_impl(impl, g.keys)
    B = src.shape[0]
    order, _, src_s, _, cand, found, slab, lane = _classify(g, src, dst)
    hit = found & cand
    slab_commit(g.keys, g.degree, None,
                torch.where(hit, slab, g.capacity_slabs),
                torch.where(hit, lane, 0),
                torch.full_like(src, TOMBSTONE_KEY),
                torch.where(hit, src_s, g.n_vertices),
                torch.full_like(src, -1))
    deleted = torch.zeros(B, dtype=torch.bool, device=src.device)
    deleted[order] = hit
    g.n_edges = g.n_edges - hit.sum(dtype=torch.int32)
    return g, deleted


@timed_dispatch("slab_update")
def apply_update(g: SlabGraph, ins_src=None, ins_dst=None, ins_w=None,
                 del_src=None, del_dst=None, *, impl: str = "auto"):
    """One mixed epoch, deletes before inserts; returns
    ``(graph, inserted_mask | None, deleted_mask | None)``."""
    kw = dict(impl=impl)
    ins_mask = del_mask = None
    if del_src is not None:
        g, del_mask = delete_edges(g, del_src, del_dst, **kw)
    if ins_src is not None:
        g, ins_mask = insert_edges(g, ins_src, ins_dst, ins_w, **kw)
    return g, ins_mask, del_mask


@timed_dispatch("slab_update")
def update_views(views: Tuple[SlabGraph, ...], roles: Tuple[str, ...],
                 ins=None, dels=None, *, impl: str = "auto"):
    """Apply one canonical batch to every view; deletes before inserts.

    ``roles`` (parallel to ``views``) come from FORWARD, TRANSPOSE and
    SYMMETRIC and must include FORWARD.  The transpose and symmetric
    batches derive from the canonical (src, dst) batch (swap, concat).
    ``ins`` is ``(src, dst, w | None)``, ``dels`` is ``(src, dst)``.
    Returns ``(views, inserted_mask, deleted_mask)``, masks over the
    forward view's batch.  Consumes the views.
    """
    if FORWARD not in roles:
        raise ValueError("update_views requires a forward view")
    kw = dict(impl=impl)
    views = list(views)
    fidx = roles.index(FORWARD)
    ins_mask = del_mask = None

    if dels is not None:
        ds, dd = dels
        # forward first: the symmetric union asks the post-delete forward
        # view whether the reverse direction survives
        views[fidx], del_mask = delete_edges(views[fidx], ds, dd, **kw)
        for i, role in enumerate(roles):
            if role == TRANSPOSE:
                views[i], _ = delete_edges(views[i], dd, ds, **kw)
            elif role == SYMMETRIC:
                gone = ~query_edges(views[fidx], dd, ds, **kw)
                s2 = torch.cat([torch.where(gone, ds, INVALID_VERTEX),
                                torch.where(gone, dd, INVALID_VERTEX)])
                views[i], _ = delete_edges(views[i], s2,
                                           torch.cat([dd, ds]), **kw)

    if ins is not None:
        s, d, w = ins
        views[fidx], ins_mask = insert_edges(views[fidx], s, d, w, **kw)
        for i, role in enumerate(roles):
            if role == TRANSPOSE:
                views[i], _ = insert_edges(views[i], d, s, w, **kw)
            elif role == SYMMETRIC:
                views[i], _ = insert_edges(
                    views[i], torch.cat([s, d]), torch.cat([d, s]),
                    None if w is None else torch.cat([w, w]), **kw)

    return tuple(views), ins_mask, del_mask


# ----------------------------------------------------------------------------
# stacked shard plane: the engine on every shard of a leading shard axis
# ----------------------------------------------------------------------------

#: the per-graph bodies without the instrumentation wrapper
query_edges_local = query_edges.__wrapped__
insert_edges_local = insert_edges.__wrapped__
delete_edges_local = delete_edges.__wrapped__


@timed_dispatch("slab_update")
def update_shards(graphs: SlabGraph, ins=None, dels=None, *,
                  impl: str = "auto"):
    """One mixed update epoch on a shard-stacked graph, deletes before
    inserts, shard by shard.

    ``graphs`` carries a leading shard axis on every tensor field;
    ``ins`` is ``(src, dst, w | None)`` and ``dels`` ``(src, dst)``, each
    ``(n_shards, cap)`` owner-routed batches (INVALID padding, src
    shard-local, dst global).  Returns ``(graphs, inserted_mask | None,
    deleted_mask | None)`` with ``(n_shards, cap)`` masks.  Consumes
    ``graphs`` (the stacked pools are written in place).
    """
    ins_masks, del_masks = [], []
    for k in range(graphs.keys.shape[0]):
        g = shard_view(graphs, k)
        if dels is not None:
            g, m = delete_edges_local(g, dels[0][k], dels[1][k], impl=impl)
            del_masks.append(m)
        if ins is not None:
            g, m = insert_edges_local(
                g, ins[0][k], ins[1][k],
                None if ins[2] is None else ins[2][k], impl=impl)
            ins_masks.append(m)
        write_back(graphs, k, g)
    return (graphs, torch.stack(ins_masks) if ins is not None else None,
            torch.stack(del_masks) if dels is not None else None)


@timed_dispatch("slab_update")
def query_shards(graphs: SlabGraph, src: torch.Tensor, dst: torch.Tensor,
                 *, impl: str = "auto") -> torch.Tensor:
    """Membership over a shard-stacked graph: ``(n_shards, cap)``
    owner-routed queries to an ``(n_shards, cap)`` found mask."""
    return torch.stack([
        query_edges_local(shard_view(graphs, k), src[k], dst[k], impl=impl)
        for k in range(graphs.keys.shape[0])])


__all__ = ["IMPLS", "FORWARD", "TRANSPOSE", "SYMMETRIC", "query_edges",
           "insert_edges", "delete_edges", "apply_update", "update_views",
           "query_edges_local", "insert_edges_local", "delete_edges_local",
           "update_shards", "query_shards", "slab_probe", "slab_commit"]
