"""SlabGraph: the pooled, hash-bucketed dynamic adjacency, as torch tensors.

The object model is the reference's (``repro.core.slab_graph``) field for
field, so that pools compare leaf for leaf:

  * one key pool        ``keys        : (S, 128) int32`` (uint32 bit patterns)
  * one weight pool     ``weights     : (S, 128) float32`` or None
  * chain pointers      ``next_slab   : (S,) int32``, -1 ends a chain
  * slab owner          ``slab_vertex : (S,) int32``, -1 = unallocated
  * bucket layout       ``bucket_offset`` (V+1,), ``bucket_count`` (V,),
    ``bucket_vertex`` (B,); the head slab of global bucket ``b`` is row ``b``
  * append state        ``tail_slab`` / ``tail_fill`` per bucket
  * UpdateIterator      ``upd_flag`` / ``upd_slab`` / ``upd_lane`` per bucket
  * allocator           ``next_free``, ``epoch_next_free``, ``free_list``,
    ``free_top``, ``slab_new``
  * bookkeeping         ``degree`` (V,), ``n_edges``

Scalars are 0-d int32 tensors on the graph's device, so the update engine
never waits for the host.  The engine mutates a graph's tensors in place
(the reference donates its buffers for the same effect): a graph handed to
an update entry point is consumed, and the caller threads the returned one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .hashing import (EMPTY_KEY, INVALID_SLAB, SLAB_WIDTH, TOMBSTONE_KEY,
                      is_valid_vertex)

#: tensor fields in the reference's pytree order
FIELDS = ("keys", "weights", "next_slab", "slab_vertex", "bucket_offset",
          "bucket_count", "bucket_vertex", "tail_slab", "tail_fill",
          "upd_flag", "upd_slab", "upd_lane", "next_free", "epoch_next_free",
          "free_list", "free_top", "slab_new", "degree", "n_edges")


@dataclasses.dataclass
class SlabGraph:
    keys: torch.Tensor
    weights: Optional[torch.Tensor]
    next_slab: torch.Tensor
    slab_vertex: torch.Tensor
    bucket_offset: torch.Tensor
    bucket_count: torch.Tensor
    bucket_vertex: torch.Tensor
    tail_slab: torch.Tensor
    tail_fill: torch.Tensor
    upd_flag: torch.Tensor
    upd_slab: torch.Tensor
    upd_lane: torch.Tensor
    next_free: torch.Tensor
    epoch_next_free: torch.Tensor
    free_list: torch.Tensor
    free_top: torch.Tensor
    slab_new: torch.Tensor
    degree: torch.Tensor
    n_edges: torch.Tensor
    n_vertices: int
    n_buckets: int
    weighted: bool

    @property
    def capacity_slabs(self) -> int:
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def nbytes(self) -> int:
        """Device bytes held by the representation (Table 5 accounting):
        ``numel * itemsize`` summed over every tensor field.  Each field has
        the reference's item size: keys int32 (the reference's uint32),
        weights float32, pointers, counters and the 0-d scalars int32, the
        ``upd_flag`` and ``slab_new`` flags one byte, so the count is the
        reference's ``SlabGraph.nbytes()``."""
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, name) for name in FIELDS)
                   if t is not None)


# ============================================================================
# Construction
# ============================================================================

def plan_buckets(n_vertices: int, init_degree: np.ndarray, *,
                 load_factor: float = 0.7, hashing: bool = True) -> np.ndarray:
    """Head slabs per vertex from the initial degree and load factor; one
    per vertex with hashing off (the single-bucket mode)."""
    if not hashing:
        return np.ones(n_vertices, dtype=np.int32)
    per_slab = SLAB_WIDTH * load_factor
    return np.maximum(1, np.ceil(init_degree / per_slab)).astype(np.int32)


def next_pow2(n: int, lo: int = 64) -> int:
    """Smallest power of two >= max(n, lo)."""
    return 1 << max(int(n) - 1, lo - 1, 1).bit_length()


def empty(n_vertices: int, bucket_count: np.ndarray, capacity_slabs: int, *,
          weighted: bool = False, device="cuda") -> SlabGraph:
    """An empty graph: head slab of bucket ``b`` is row ``b``; overflow slabs
    are bump-allocated from row ``n_buckets`` up.  On ``cuda`` unless
    ``device="cpu"``; raises without a card.

    Only ``bucket_count`` crosses from the host; the pool is filled on the
    device (the triangle plane builds one per update epoch)."""
    dev = resolve_device(device)
    bucket_count = np.asarray(bucket_count, dtype=np.int32)
    if bucket_count.shape != (n_vertices,):
        raise ValueError(f"bucket_count has shape {bucket_count.shape}, "
                         f"expected ({n_vertices},)")
    n_buckets = int(bucket_count.sum(dtype=np.int64))
    S = int(max(capacity_slabs, n_buckets + 1))
    i32 = dict(dtype=torch.int32, device=dev)
    count = torch.tensor(bucket_count, device=dev)
    bucket_offset = torch.zeros(n_vertices + 1, **i32)
    bucket_offset[1:] = torch.cumsum(count, 0, dtype=torch.int32)
    bucket_vertex = torch.repeat_interleave(
        torch.arange(n_vertices, **i32), count, output_size=n_buckets)
    slab_vertex = torch.full((S,), -1, **i32)
    slab_vertex[:n_buckets] = bucket_vertex
    return SlabGraph(
        keys=torch.full((S, SLAB_WIDTH), EMPTY_KEY, **i32),
        weights=(torch.zeros((S, SLAB_WIDTH), dtype=torch.float32,
                             device=dev) if weighted else None),
        next_slab=torch.full((S,), INVALID_SLAB, **i32),
        slab_vertex=slab_vertex,
        bucket_offset=bucket_offset,
        bucket_count=count,
        bucket_vertex=bucket_vertex,
        tail_slab=torch.arange(n_buckets, **i32),
        tail_fill=torch.zeros(n_buckets, **i32),
        upd_flag=torch.zeros(n_buckets, dtype=torch.bool, device=dev),
        upd_slab=torch.arange(n_buckets, **i32),
        upd_lane=torch.zeros(n_buckets, **i32),
        next_free=torch.tensor(n_buckets, **i32),
        epoch_next_free=torch.tensor(n_buckets, **i32),
        free_list=torch.full((S,), INVALID_SLAB, **i32),
        free_top=torch.zeros((), **i32),
        slab_new=torch.zeros(S, dtype=torch.bool, device=dev),
        degree=torch.zeros(n_vertices, **i32),
        n_edges=torch.zeros((), **i32),
        n_vertices=n_vertices, n_buckets=n_buckets, weighted=weighted)


def _from_host(fields: dict, device) -> SlabGraph:
    from .bridge import slab_graph_from_numpy
    return slab_graph_from_numpy(fields, device)


def ensure_capacity(g: SlabGraph, extra_slabs: int) -> SlabGraph:
    """Grow the pool (host-side, between epochs) so that at least
    ``extra_slabs`` slabs are allocatable; free-list slabs count.  Grown
    capacities are powers of two and grow by at least 1.5x, as in the
    reference."""
    free = g.capacity_slabs - int(g.next_free) + int(g.free_top)
    if free >= extra_slabs:
        return g
    target = max(int(g.next_free) - int(g.free_top) + extra_slabs,
                 g.capacity_slabs + g.capacity_slabs // 2)
    grow = next_pow2(target) - g.capacity_slabs

    def pad_rows(a, fill):
        pad = torch.full((grow,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a, pad], dim=0)

    return dataclasses.replace(
        g,
        keys=pad_rows(g.keys, EMPTY_KEY),
        weights=None if g.weights is None else pad_rows(g.weights, 0.0),
        next_slab=pad_rows(g.next_slab, INVALID_SLAB),
        slab_vertex=pad_rows(g.slab_vertex, -1),
        free_list=pad_rows(g.free_list, INVALID_SLAB),
        slab_new=pad_rows(g.slab_new, False),
    )


def update_slab_pointers(g: SlabGraph) -> SlabGraph:
    """Close the update epoch: clear ``upd_flag`` and ``slab_new``, point the
    UpdateIterator at the current tails, record the allocator watermark.

    The reference lets ``upd_slab``/``upd_lane`` alias ``tail_slab``/
    ``tail_fill``; here the engine writes those tensors in place, so the
    epoch-close state takes copies.
    """
    return dataclasses.replace(
        g,
        upd_flag=torch.zeros_like(g.upd_flag),
        upd_slab=g.tail_slab.clone(),
        upd_lane=g.tail_fill.clone(),
        epoch_next_free=g.next_free.clone(),
        slab_new=torch.zeros_like(g.slab_new),
    )


# ============================================================================
# Stacked pools: a leading shard axis on every tensor field
# ============================================================================

def stack_graphs(graphs) -> SlabGraph:
    """One graph whose tensor fields stack ``graphs``' along a new leading
    shard axis (every graph has the same shapes and metadata)."""
    g0 = graphs[0]
    return dataclasses.replace(g0, **{
        f: (None if getattr(g0, f) is None
            else torch.stack([getattr(g, f) for g in graphs]))
        for f in FIELDS})


def shard_view(graphs: SlabGraph, k: int) -> SlabGraph:
    """Shard ``k`` of a stacked graph, its tensors views into the stacked
    ones: the engine's in-place writes land in the stack."""
    return dataclasses.replace(graphs, **{
        f: None if getattr(graphs, f) is None else getattr(graphs, f)[k]
        for f in FIELDS})


def write_back(graphs: SlabGraph, k: int, g: SlabGraph) -> None:
    """Copy into shard ``k`` of ``graphs`` every field the engine re-bound
    on ``g`` (a ``shard_view`` it was handed) instead of writing in place;
    the fields it wrote in place are the stack's already."""
    for f in FIELDS:
        t = getattr(g, f)
        if t is None:
            continue
        dst = getattr(graphs, f)[k]
        if t.data_ptr() != dst.data_ptr():
            dst.copy_(t)


# ============================================================================
# Host-side bulk construction
# ============================================================================

def from_edges_numpy(n_vertices: int, src, dst, weights=None, *,
                     load_factor: float = 0.7, hashing: bool = True,
                     slack_slabs: int = 0) -> dict:
    """The fields of a SlabGraph built from a static edge list, as numpy
    arrays (keys as int32 bit patterns).  Identical to inserting the edges
    into an empty graph; duplicate (src, dst) pairs are dropped."""
    src = np.asarray(src).astype(np.uint32)
    dst = np.asarray(dst).astype(np.uint32)
    w = None if weights is None else np.asarray(weights, dtype=np.float32)

    key = src.astype(np.uint64) * np.uint64(2 ** 32) + dst.astype(np.uint64)
    _, uniq_idx = np.unique(key, return_index=True)
    uniq_idx.sort()
    src, dst = src[uniq_idx], dst[uniq_idx]
    if w is not None:
        w = w[uniq_idx]

    src64 = src.astype(np.int64)
    deg = np.bincount(src64, minlength=n_vertices).astype(np.int32)
    bucket_count = plan_buckets(n_vertices, deg, load_factor=load_factor,
                                hashing=hashing)
    bucket_offset = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(bucket_count, out=bucket_offset[1:])
    n_buckets = int(bucket_offset[-1])

    h = ((dst.astype(np.uint64) * 2654435761) & 0xFFFFFFFF) >> 8
    b = bucket_offset[src64] + (h % bucket_count[src64].astype(np.uint64)
                                ).astype(np.int64)
    order = np.argsort(b, kind="stable")
    b_s, dst_s = b[order], dst[order]
    w_s = None if w is None else w[order]

    per_bucket = np.bincount(b_s, minlength=n_buckets)
    extra = np.maximum(0, -(-per_bucket // SLAB_WIDTH) - 1)
    extra_off = np.zeros(n_buckets + 1, dtype=np.int64)
    np.cumsum(extra, out=extra_off[1:])
    total_slabs = n_buckets + int(extra_off[-1])
    capacity = next_pow2(total_slabs + max(slack_slabs,
                                           total_slabs // 2 + 64))

    keys = np.full((capacity, SLAB_WIDTH), EMPTY_KEY, dtype=np.int32)
    wpool = (np.zeros((capacity, SLAB_WIDTH), dtype=np.float32)
             if w is not None else None)
    nxt = np.full(capacity, -1, dtype=np.int32)
    slab_vertex = np.full(capacity, -1, dtype=np.int32)
    bucket_vertex = np.repeat(np.arange(n_vertices, dtype=np.int32),
                              bucket_count)
    slab_vertex[:n_buckets] = bucket_vertex

    start = np.zeros(len(b_s), dtype=np.int64)
    if len(b_s):
        run_start = np.ones(len(b_s), dtype=bool)
        run_start[1:] = b_s[1:] != b_s[:-1]
        idx = np.arange(len(b_s), dtype=np.int64)
        start = np.maximum.accumulate(np.where(run_start, idx, 0))
    rank = np.arange(len(b_s), dtype=np.int64) - start

    slab_of = np.where(rank < SLAB_WIDTH, b_s,
                       n_buckets + extra_off[b_s] + (rank // SLAB_WIDTH) - 1)
    lane_of = rank % SLAB_WIDTH
    keys[slab_of, lane_of] = dst_s.view(np.int32)
    if wpool is not None:
        wpool[slab_of, lane_of] = w_s

    # overflow slab k (row n_buckets + k) belongs to the bucket whose
    # [extra_off[b], extra_off[b+1]) range holds k and links to row k + 1
    # unless it is that bucket's last; the head links to the first one
    total_extra = int(extra_off[-1])
    if total_extra:
        has = extra > 0
        nxt[np.nonzero(has)[0]] = (n_buckets + extra_off[:-1][has]).astype(
            np.int32)
        own = np.repeat(np.arange(n_buckets, dtype=np.int64), extra)
        ids = n_buckets + np.arange(total_extra, dtype=np.int64)
        slab_vertex[ids] = bucket_vertex[own]
        is_last = (ids - n_buckets + 1) == extra_off[own + 1]
        nxt[ids[~is_last]] = (ids[~is_last] + 1).astype(np.int32)

    tail_slab = np.where(extra > 0, n_buckets + extra_off[:-1] + extra - 1,
                         np.arange(n_buckets)).astype(np.int32)
    tail_fill = np.where(
        per_bucket > 0,
        per_bucket - (-(-per_bucket // SLAB_WIDTH) - 1) * SLAB_WIDTH,
        0).astype(np.int32)

    return dict(
        keys=keys, weights=wpool, next_slab=nxt, slab_vertex=slab_vertex,
        bucket_offset=bucket_offset.astype(np.int32),
        bucket_count=bucket_count, bucket_vertex=bucket_vertex,
        tail_slab=tail_slab, tail_fill=tail_fill,
        upd_flag=np.zeros(n_buckets, dtype=bool),
        upd_slab=tail_slab.copy(), upd_lane=tail_fill.copy(),
        next_free=np.int32(total_slabs),
        epoch_next_free=np.int32(total_slabs),
        free_list=np.full(capacity, -1, dtype=np.int32),
        free_top=np.int32(0),
        slab_new=np.zeros(capacity, dtype=bool),
        degree=deg, n_edges=np.int32(len(src)))


def from_edges_host(n_vertices: int, src, dst, weights=None, *,
                    load_factor: float = 0.7, hashing: bool = True,
                    slack_slabs: int = 0, device="cuda") -> SlabGraph:
    """Build the pool on the host with numpy, then move it to ``device``
    (``cuda`` unless ``device="cpu"``; raises without a card)."""
    return _from_host(from_edges_numpy(
        n_vertices, src, dst, weights, load_factor=load_factor,
        hashing=hashing, slack_slabs=slack_slabs), device)


# ============================================================================
# Pool health
# ============================================================================

def pool_stats(g: SlabGraph, *, chains: bool = True) -> dict:
    """Pool-health snapshot: live and tombstone lanes, dead slabs, chain
    lengths (slabs per bucket, head included).  ``chains=False`` leaves out
    ``max_chain`` and ``mean_chain``, whose walk syncs once per hop of the
    longest chain."""
    alloc = g.slab_vertex >= 0
    live_lane = alloc[:, None] & is_valid_vertex(g.keys)
    tomb_lane = alloc[:, None] & (g.keys == TOMBSTONE_KEY)
    live_per_slab = live_lane.sum(dim=1)
    live_lanes = int(live_per_slab.sum())
    tombstone_lanes = int(tomb_lane.sum())
    allocated_slabs = int(alloc.sum())
    is_head = torch.arange(g.capacity_slabs, device=g.device) < g.n_buckets
    dead_slabs = int((alloc & ~is_head & (live_per_slab == 0)).sum())

    occupied = live_lanes + tombstone_lanes
    stats = {
        "capacity_slabs": g.capacity_slabs,
        "next_free": int(g.next_free),
        "free_top": int(g.free_top),
        "free_slabs": g.capacity_slabs - int(g.next_free) + int(g.free_top),
        "allocated_slabs": allocated_slabs,
        "dead_slabs": dead_slabs,
        "live_lanes": live_lanes,
        "tombstone_lanes": tombstone_lanes,
        "tombstone_ratio": tombstone_lanes / max(1, occupied),
        "occupancy": live_lanes / max(1, allocated_slabs * SLAB_WIDTH),
        "pool_bytes": int(g.keys.numel() * 4 + (
            g.weights.numel() * 4 if g.weights is not None else 0)),
        "n_edges": int(g.n_edges),
    }
    if chains:
        # walk every chain at once from its head (row b is bucket b's head)
        lengths = torch.zeros(g.n_buckets, dtype=torch.int64, device=g.device)
        bucket = torch.arange(g.n_buckets, dtype=torch.int64,
                              device=g.device)
        cur = bucket
        while cur.numel():
            lengths[bucket] += 1
            nxt = g.next_slab[cur].to(torch.int64)
            keep = nxt >= 0
            cur, bucket = nxt[keep], bucket[keep]
        stats["max_chain"] = int(lengths.max()) if g.n_buckets else 0
        stats["mean_chain"] = (float(lengths.double().mean())
                               if g.n_buckets else 0.0)
    return stats
