"""The slab-compaction engine: the maintenance plane of the pool.

The update plane only appends (deletes leave tombstones, ``next_free`` only
advances), so under churn the pool grows and every sweep and chain walk
pays for dead lanes.  Two tiers keep it dense:

* ``compact``            - re-pack every bucket's survivors into the cold
  layout (chain-walk order kept), rebuild chains, tails and degrees, reset
  the allocator, and optionally shrink the pool down the power-of-two
  ladder ``ensure_capacity`` grows along.  Returns the new graph and a
  ``CompactionReport`` with the old-to-new slab map.
* ``reclaim_free_slabs`` - unlink wholly dead overflow slabs and push them
  onto the free list, which insert placement drains before the bump
  pointer.  No lane moves and the capacity stays.

``impl`` chooses the plan of ``compact``: ``"auto"`` follows the tensors
(``core.device.resolve_impl``: the census and chain-rank kernels on the
card, their plain versions on the CPU), ``"cuda"`` and ``"torch"`` ask for
one of those, and ``"oracle"`` runs the sort-based rebuild of ``ref.py``.
All give the same pool and map, leaf for leaf.  The re-pack itself is a
PyTorch scatter, as the reference leaves it to XLA.

Both entry points run on a closed epoch and reset the epoch state.  They
build new key pools (``compact``) or write the old one in place
(``reclaim_free_slabs``): either way the graph passed in is consumed, and
the caller threads the one that comes back.  ``compact_shards`` and
``reclaim_shards`` do the same to shard-stacked pools, shard by shard;
every compacted shard lands on one capacity, so the stack stays
rectangular.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ...core.device import resolve_impl
from ...core.hashing import EMPTY_KEY, INVALID_SLAB, SLAB_WIDTH
from ...core.slab_graph import (SlabGraph, next_pow2, shard_view,
                                stack_graphs, write_back)
from ...obs.instrument import timed_dispatch
from .kernel import chain_rank, chain_rank_torch, slab_live, slab_live_torch
from .ref import (assemble, chain_order, compact_ref, live_lane_mask, perm_of,
                  rebuild_links, recount_degrees, slab_of_rank)

IMPLS = ("auto", "cuda", "torch", "oracle")


@dataclasses.dataclass(frozen=True)
class CompactionReport:
    """What one compaction did, for the maintenance policy and the store."""
    perm: torch.Tensor       # (S_old,) old -> new slab, INVALID_SLAB = dead
    live_lanes: int          # lanes that survived (== n_edges)
    live_slabs: int          # allocated rows after (n_buckets + overflow)
    old_capacity: int
    new_capacity: int
    old_next_free: int
    new_next_free: int

    @property
    def freed_slabs(self) -> int:
        return self.old_next_free - self.new_next_free

    @property
    def shrunk(self) -> bool:
        return self.new_capacity < self.old_capacity


# ----------------------------------------------------------------------------
# plan: per-slab live census and chain ranks (the two pool-wide passes)
# ----------------------------------------------------------------------------

def _plan(g: SlabGraph, *, plain: bool = False):
    live, chain = ((slab_live_torch, chain_rank_torch) if plain
                   else (slab_live, chain_rank))
    live_cnt, lane_rank = live(g.keys, g.slab_vertex)
    base_rank, bucket_of, _, counts = chain(g.next_slab, live_cnt,
                                            g.n_buckets)
    return live_cnt, lane_rank, base_rank, bucket_of, counts


# ----------------------------------------------------------------------------
# commit: scatter the survivors into the new dense pool (no sort)
# ----------------------------------------------------------------------------

def _commit(g: SlabGraph, live_cnt, lane_rank, base_rank, bucket_of, counts,
            *, capacity_slabs: int) -> Tuple[SlabGraph, torch.Tensor]:
    W, nb = SLAB_WIDTH, g.n_buckets
    extra_off, total_slabs, nxt, sv, tail_slab, tail_fill = rebuild_links(
        counts, n_buckets=nb, bucket_vertex=g.bucket_vertex,
        capacity=capacity_slabs)

    # one flat destination per live lane, straight from the prefix ranks
    at = torch.nonzero(live_lane_mask(g.keys, g.slab_vertex).view(-1)
                       ).squeeze(1)
    row = at // W
    rank = base_rank[row] + lane_rank.view(-1)[at]
    dst = slab_of_rank(rank, bucket_of[row], extra_off, nb) * W + rank % W

    new_keys = torch.full((capacity_slabs, W), EMPTY_KEY, dtype=torch.int32,
                          device=g.device)
    new_keys.view(-1)[dst] = g.keys.view(-1)[at]
    new_weights = None
    if g.weighted:
        new_weights = torch.zeros((capacity_slabs, W), dtype=torch.float32,
                                  device=g.device)
        new_weights.view(-1)[dst] = g.weights.view(-1)[at]

    g2 = assemble(g, capacity=capacity_slabs, counts=counts,
                  new_keys=new_keys, new_weights=new_weights, nxt=nxt, sv=sv,
                  tail_slab=tail_slab, tail_fill=tail_fill,
                  total_slabs=total_slabs,
                  degree=recount_degrees(g, live_cnt))
    perm = perm_of(base_rank, bucket_of, live_cnt, extra_off, n_buckets=nb,
                   capacity_old=g.capacity_slabs)
    return g2, perm


def _pick_capacity(needed: int, current: int, n_buckets: int, *,
                   capacity_slabs: Optional[int], slack_slabs: int,
                   shrink: bool) -> int:
    """The power-of-two capacity ladder, downward: a compacted pool lands on
    a shape ``ensure_capacity`` grows through, and shrinks only when the
    survivors fit a strictly lower rung."""
    if capacity_slabs is not None:
        return max(int(capacity_slabs), needed, n_buckets + 1)
    cap = next_pow2(max(needed + slack_slabs, n_buckets + 1))
    if not shrink:
        cap = max(cap, current)
    return cap


@timed_dispatch("slab_compact")
def compact(g: SlabGraph, *, impl: str = "auto",
            capacity_slabs: Optional[int] = None, slack_slabs: int = 64,
            shrink: bool = True) -> Tuple[SlabGraph, CompactionReport]:
    """Compact one SlabGraph: size the new pool, then re-pack it.

    ``shrink=True`` lets the capacity drop to the power-of-two rung holding
    the surviving slabs plus ``slack_slabs``; ``shrink=False`` keeps the
    current capacity.  ``capacity_slabs`` pins the capacity (raised to what
    the survivors need).  Runs on a closed epoch; consumes ``g``.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl != "oracle":
        resolve_impl(impl, g.keys)
    # the oracle sizes its pool from the plain plan, as the reference does
    plan = _plan(g, plain=impl == "oracle")
    counts_h = plan[-1].cpu()
    extra = (counts_h + SLAB_WIDTH - 1) // SLAB_WIDTH - 1
    needed = g.n_buckets + int(extra[extra > 0].sum())
    cap = _pick_capacity(needed, g.capacity_slabs, g.n_buckets,
                         capacity_slabs=capacity_slabs,
                         slack_slabs=slack_slabs, shrink=shrink)
    if impl == "oracle":
        del plan
        g2, perm = compact_ref(g, capacity_slabs=cap)
    else:
        g2, perm = _commit(g, *plan, capacity_slabs=cap)
    report = CompactionReport(
        perm=perm, live_lanes=int(counts_h.sum()), live_slabs=needed,
        old_capacity=g.capacity_slabs, new_capacity=cap,
        old_next_free=int(g.next_free), new_next_free=int(g2.next_free))
    return g2, report


# ----------------------------------------------------------------------------
# the light tier: wholly dead slabs back onto the free list
# ----------------------------------------------------------------------------

def _chain_tails(next_slab: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) last slab of every chain, walked from the heads."""
    tail = torch.arange(n_buckets, dtype=torch.int32,
                        device=next_slab.device)
    bucket = tail.long()
    cur = bucket
    while cur.numel():
        nxt = next_slab[cur]
        keep = nxt != INVALID_SLAB
        bucket, cur = bucket[keep], nxt[keep].long()
        tail[bucket] = cur.to(torch.int32)
    return tail


@timed_dispatch("slab_compact")
def reclaim_free_slabs(g: SlabGraph) -> Tuple[SlabGraph, int]:
    """Unlink wholly dead overflow slabs and recycle them; ``(graph,
    n_reclaimed)``.

    Head slabs are never reclaimed (they are the buckets' entry points).
    Chain contents and order are unchanged, so queries and sweeps are too.
    The freed rows go onto the free list in ascending order, scrubbed.
    Runs on a closed epoch; writes ``g``'s pools in place and consumes it.
    """
    S, nb, W = g.capacity_slabs, g.n_buckets, SLAB_WIDTH
    live_cnt = live_lane_mask(g.keys, g.slab_vertex).sum(dim=1)
    rows = torch.arange(S, dtype=torch.int32, device=g.device)
    dead = (g.slab_vertex >= 0) & (rows >= nb) & (live_cnt == 0)

    # pointer-jump every next pointer over dead slabs
    nxt = g.next_slab
    while True:
        t = nxt.clamp_min(0).long()
        jump = (nxt >= 0) & dead[t]
        if not bool(jump.any()):
            break
        nxt = torch.where(jump, nxt[t], nxt)
    new_next = torch.where(dead, INVALID_SLAB, nxt)

    # a chain whose dead suffix was cut has a new tail, and that tail was
    # full (it overflowed into the slabs that died)
    tail2 = _chain_tails(new_next, nb)
    fill2 = torch.where(tail2 == g.tail_slab, g.tail_fill, W).to(torch.int32)

    m = dead.to(torch.int32)
    pos = g.free_top + torch.cumsum(m, 0, dtype=torch.int32) - m
    free_list = g.free_list.clone()
    free_list[pos[dead].long()] = rows[dead]
    n_freed = int(m.sum())

    g.keys[dead] = EMPTY_KEY
    if g.weights is not None:
        g.weights[dead] = 0.0
    g2 = dataclasses.replace(
        g, next_slab=new_next,
        slab_vertex=torch.where(dead, -1, g.slab_vertex),
        tail_slab=tail2, tail_fill=fill2,
        upd_flag=torch.zeros_like(g.upd_flag), upd_slab=tail2.clone(),
        upd_lane=fill2.clone(), epoch_next_free=g.next_free.clone(),
        free_list=free_list, free_top=g.free_top + n_freed,
        slab_new=torch.zeros_like(g.slab_new))
    return g2, n_freed


# ----------------------------------------------------------------------------
# shard-stacked pools
# ----------------------------------------------------------------------------

@timed_dispatch("slab_compact")
def compact_shards(graphs: SlabGraph, *, impl: str = "auto",
                   capacity_slabs: Optional[int] = None,
                   slack_slabs: int = 64, shrink: bool = True,
                   agree_need: Optional[Callable[[int], int]] = None
                   ) -> Tuple[SlabGraph, CompactionReport]:
    """Compact a shard-stacked graph (a leading shard axis on every tensor
    field).  Every shard lands on one power-of-two capacity, sized from
    the largest survivor need over the shards, so the stack stays
    rectangular.  The report sums over the shards; ``perm`` is
    ``(n_shards, S_old)``.  Consumes ``graphs``.

    Where the plane's other shards lie in other processes, ``agree_need``
    turns this stack's need (rows) into the one they all size from (the
    sharded store's mesh passes a max over its ranks); the report's
    counts stay this stack's."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl != "oracle":
        resolve_impl(impl, graphs.keys)
    shards = [shard_view(graphs, k) for k in range(graphs.keys.shape[0])]
    plans = [_plan(g, plain=impl == "oracle") for g in shards]
    counts_h = torch.stack([p[-1] for p in plans]).cpu()  # (n_shards, nb)
    extra = ((counts_h + SLAB_WIDTH - 1) // SLAB_WIDTH - 1).clamp_min(0)
    nb, old_cap = graphs.n_buckets, graphs.keys.shape[1]
    needed = nb + int(extra.sum(dim=1).max())
    if agree_need is not None:
        needed = agree_need(needed)
    cap = _pick_capacity(needed, old_cap, nb, capacity_slabs=capacity_slabs,
                         slack_slabs=slack_slabs, shrink=shrink)
    outs = [compact_ref(g, capacity_slabs=cap) if impl == "oracle"
            else _commit(g, *plan, capacity_slabs=cap)
            for g, plan in zip(shards, plans)]
    old_next_free = int(graphs.next_free.max())
    del shards, plans, graphs
    g2 = stack_graphs([o[0] for o in outs])
    report = CompactionReport(
        perm=torch.stack([o[1] for o in outs]),
        live_lanes=int(counts_h.sum()), live_slabs=needed,
        old_capacity=old_cap, new_capacity=cap,
        old_next_free=old_next_free, new_next_free=int(g2.next_free.max()))
    return g2, report


@timed_dispatch("slab_compact")
def reclaim_shards(graphs: SlabGraph) -> Tuple[SlabGraph, int]:
    """``reclaim_free_slabs`` on every shard of a stacked graph (the
    capacity stays); ``(graphs, slabs reclaimed over all shards)``."""
    total = 0
    for k in range(graphs.keys.shape[0]):
        g, n = reclaim_free_slabs.__wrapped__(shard_view(graphs, k))
        write_back(graphs, k, g)
        total += n
    return graphs, total


__all__ = ["IMPLS", "CompactionReport", "compact", "compact_shards",
           "reclaim_free_slabs", "reclaim_shards", "slab_live", "chain_rank"]
