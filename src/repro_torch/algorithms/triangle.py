"""Dynamic triangle counting (paper §4.3, Appendix A.1, Algs. 7-9), from
``repro.algorithms.triangle``.

Inclusion-exclusion over (graph, update-graph) pairs after Makkar, Bader &
Green.  The counting core is the ``kernels.slab_intersect`` family
(``count_edges``); this module drives it:

  * ``triangles_static``       - edge-parallel count over the compacted edge
    set, with grow-and-retry on compaction overflow.
  * ``triangles_incremental``  / ``triangles_decremental`` - Algs. 7/8 via
    the Count() inclusion-exclusion, with the batch graph B built on the
    device through the slab-update engine (``batch_graph``).
  * ``stream_property``        - a live triangle count through
    ``GraphStore.apply`` epochs: incremental delta on insert-only batches,
    decremental on delete-only, a static recount on mixed or self-loop
    epochs.  Maintenance epochs leave the count untouched.

With the batch in BOTH orientations (undirected adjacency):

  ΔT_inc = ½ · (S₁ − S₂ + S₃/3),  S₁=Count(G′,G′), S₂=Count(G′,B), S₃=Count(B,B)
  ΔT_dec = ½ · (S₁ + S₂ + S₃/3),  S₁=Count(A,A),  S₂=Count(A,B),  S₃=Count(B,B)

(G′ = post-insertion graph, A = post-deletion graph, B = batch graph.)

Hashing stays on for triangle counting (paper §6.3: restricting the probe
to one bucket's slab list speeds the count up ~15×).  ``max_bpv`` bounds
only the candidate enumeration from G2's buckets, so the single-bucket
batch graph runs with ``batch_bpv=1``.

Every count and total is a 0-d int64 tensor (the reference's int32 total
wraps at the serve's RMAT scale-20 graph).  Ids travel as int32 bit
patterns of uint32 vertex ids, so order comparisons between ids are made
on the unsigned value.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.hashing import INVALID_VERTEX, SLAB_WIDTH
from ..core.slab_graph import SlabGraph, empty, next_pow2
from ..core.worklist import pool_edges
from ..kernels.slab_intersect import count_edges
from ..kernels.slab_intersect.ref import search_edges_ref as search_edges

_MASK32 = 0xFFFFFFFF
_STREAM_CHUNK = 8192      # edges per static-count launch of the property


def count_kernel(g1: SlabGraph, g2: SlabGraph, us: torch.Tensor,
                 vs: torch.Tensor, emask: torch.Tensor, *, max_bpv: int = 4,
                 impl: str = "auto") -> torch.Tensor:
    """Alg. 9's ``Count(G1, G2, edges)``: the family's ``count_edges`` under
    the reference's name."""
    return count_edges(g1, g2, us, vs, emask, impl=impl, max_bpv=max_bpv)


def compact_edges(g: SlabGraph, *, max_edges: int):
    """Dense ``(src, dst, count, overflow)`` of the current edge set in pool
    order: (max_edges,) int32 id buffers, zero past ``count``.

    ``overflow`` is the number of live lanes that did NOT fit in
    ``max_edges``, the witness ``triangles_static`` grows and retries on.
    Only the live lanes are gathered, so the temporaries follow the edges,
    not the pool.
    """
    lane = torch.nonzero(pool_edges(g).valid.reshape(-1)).squeeze(1)
    total = lane.numel()
    n = min(total, max_edges)
    lane = lane[:n]
    es = torch.zeros(max_edges, dtype=torch.int32, device=g.device)
    ed = torch.zeros(max_edges, dtype=torch.int32, device=g.device)
    es[:n] = g.slab_vertex[lane // SLAB_WIDTH]
    ed[:n] = g.keys.reshape(-1)[lane]
    i32 = dict(dtype=torch.int32, device=g.device)
    return (es, ed, torch.tensor(n, **i32),
            torch.tensor(max(total - max_edges, 0), **i32))


def triangles_static(g: SlabGraph, *, max_bpv: int = 4,
                     max_edges: Optional[int] = None, chunk: int = 8192,
                     impl: str = "auto") -> torch.Tensor:
    """Static count over an undirected graph (both orientations stored):
    Σ_{(u,v)} |N(u) ∩ N(v)| counts each triangle 6×.

    Edge-parallel over the compacted edges in fixed-size chunks.  The
    compaction capacity starts at ``max_edges`` (default: the live edge
    count rounded up to a power of two) and grows on the overflow witness;
    the pool's lane count is a hard ceiling, so the ladder ends.
    """
    cap_pool = g.capacity_slabs * SLAB_WIDTH
    cap = min(cap_pool, max_edges if max_edges is not None
              else next_pow2(max(int(g.n_edges), 1)))
    attempts = max(4, cap_pool.bit_length() + 1)
    for _ in range(attempts):
        es, ed, n, overflow = compact_edges(g, max_edges=cap)
        if int(overflow) == 0 or cap >= cap_pool:
            break
        cap = min(cap * 2, cap_pool)
    else:
        from ..resilience.guard import RetryExhausted
        raise RetryExhausted(
            "triangle.compact", attempts,
            RuntimeError(f"compact_edges still overflows at cap {cap}"))

    n = int(n)
    es = torch.nn.functional.pad(es, (0, chunk))   # windows never run short
    ed = torch.nn.functional.pad(ed, (0, chunk))
    lanes = torch.arange(chunk, device=g.device)
    total = torch.zeros((), dtype=torch.int64, device=g.device)
    for c0 in range(0, n, chunk):
        total = total + count_edges(
            g, g, es[c0:c0 + chunk], ed[c0:c0 + chunk], lanes < (n - c0),
            impl=impl, max_bpv=max_bpv)
    return total // 6


# ---------------------------------------------------------------------------
# device-built batch graphs + canonical-pair helpers
# ---------------------------------------------------------------------------

def batch_graph(n_vertices: int, bsrc: torch.Tensor, bdst: torch.Tensor,
                bmask: torch.Tensor) -> SlabGraph:
    """The update graph B, built on the batch's device from a canonical
    batch: one bucket per vertex (so probes into B run with
    ``batch_bpv=1``), both orientations of every masked pair committed
    through the slab-update engine."""
    from ..kernels.slab_update import insert_edges
    B = int(bsrc.shape[0])
    cap = next_pow2(n_vertices + (2 * B) // SLAB_WIDTH + 2)
    gb = empty(n_vertices, np.ones(n_vertices, np.int32), cap,
               device=bsrc.device)
    gsrc = torch.cat([torch.where(bmask, bsrc, 0),
                      torch.where(bmask, bdst, 0)]).to(torch.int32)
    gdst = torch.cat([torch.where(bmask, bdst, INVALID_VERTEX),
                      torch.where(bmask, bsrc, INVALID_VERTEX)]
                     ).to(torch.int32)        # INVALID = masked lane
    gb, _ = insert_edges(gb, gsrc, gdst)
    return gb


def _canonical_sorted(lo: torch.Tensor, hi: torch.Tensor,
                      mask: torch.Tensor):
    """Stable sort of the masked pairs on (lo, hi) as unsigned words, masked
    lanes last (as U32_MAX pairs): ``(sorted lo, sort key, perm,
    eq_prev)``.

    The key is one int64, ``(lo - 2**31) * 2**32 + hi`` on the unsigned
    values, whose signed order is the pairs' unsigned order.
    """
    l_ = torch.where(mask, lo, INVALID_VERTEX).long() & _MASK32
    h_ = torch.where(mask, hi, INVALID_VERTEX).long() & _MASK32
    key = (l_ - 2 ** 31) * 2 ** 32 + h_
    sk, perm = torch.sort(key, stable=True)
    eq_prev = torch.zeros_like(mask)
    eq_prev[1:] = sk[1:] == sk[:-1]
    return l_[perm], sk, perm, eq_prev


def dedup_canonical(lo: torch.Tensor, hi: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """First-occurrence mask of each distinct masked (lo, hi) pair."""
    sl, _, perm, eq_prev = _canonical_sorted(lo, hi, mask)
    keep = torch.zeros_like(mask)
    keep[perm] = ~eq_prev & (sl != _MASK32)
    return keep


def pair_duplicated(lo: torch.Tensor, hi: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Per lane: does the masked multiset hold this (lo, hi) pair twice?

    With directed-deduped, loop-free lanes a duplicate can only be the
    reverse orientation of the same undirected pair: the "was the reverse
    edge inserted in this very batch" predicate of the stream hook.
    """
    _, sk, perm, eq_prev = _canonical_sorted(lo, hi, mask)
    eq_next = torch.zeros_like(mask)
    eq_next[:-1] = sk[:-1] == sk[1:]
    dup = torch.zeros_like(mask)
    dup[perm] = eq_prev | eq_next
    return dup & mask


def undirected_host(src, dst) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side canonical undirected dedup (numpy sort/unique)."""
    src = np.asarray(src, dtype=np.uint32)
    dst = np.asarray(dst, dtype=np.uint32)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = np.unique((lo.astype(np.uint64) << np.uint64(32))
                    | hi.astype(np.uint64))
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))


# ---------------------------------------------------------------------------
# incremental / decremental deltas (Algs. 7/8)
# ---------------------------------------------------------------------------

def _both_orientations(bsrc, bdst, bmask):
    return (torch.cat([bsrc, bdst]), torch.cat([bdst, bsrc]),
            torch.cat([bmask, bmask]))


def triangles_incremental(g_new: SlabGraph, g_batch: SlabGraph,
                          bsrc: torch.Tensor, bdst: torch.Tensor,
                          bmask: torch.Tensor, *, max_bpv: int = 4,
                          batch_bpv: Optional[int] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Alg. 7: triangles gained by inserting the batch (already applied to
    ``g_new``; ``g_batch`` holds the batch edges, both orientations).

    ``batch_bpv`` bounds candidate enumeration from ``g_batch``'s buckets
    (1 for ``batch_graph``-built graphs); defaults to ``max_bpv``.
    """
    bb = max_bpv if batch_bpv is None else batch_bpv
    us, vs, m = _both_orientations(bsrc, bdst, bmask)
    s1 = count_edges(g_new, g_new, us, vs, m, impl=impl, max_bpv=max_bpv)
    s2 = count_edges(g_new, g_batch, us, vs, m, impl=impl, max_bpv=bb)
    s3 = count_edges(g_batch, g_batch, us, vs, m, impl=impl, max_bpv=bb)
    return (3 * (s1 - s2) + s3) // 6


def triangles_decremental(g_post: SlabGraph, g_batch: SlabGraph,
                          bsrc: torch.Tensor, bdst: torch.Tensor,
                          bmask: torch.Tensor, *, max_bpv: int = 4,
                          batch_bpv: Optional[int] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Alg. 8: triangles lost by deleting the batch (already applied to
    ``g_post``)."""
    bb = max_bpv if batch_bpv is None else batch_bpv
    us, vs, m = _both_orientations(bsrc, bdst, bmask)
    s1 = count_edges(g_post, g_post, us, vs, m, impl=impl, max_bpv=max_bpv)
    s2 = count_edges(g_post, g_batch, us, vs, m, impl=impl, max_bpv=bb)
    s3 = count_edges(g_batch, g_batch, us, vs, m, impl=impl, max_bpv=bb)
    return (3 * (s1 + s2) + s3) // 6


# ---------------------------------------------------------------------------
# stream registration hook
# ---------------------------------------------------------------------------

def _sym_bpv(g: SlabGraph) -> int:
    # a power of two at or above the largest bucket count, as in the
    # reference, whose dense work-item layout it sizes; the port lists only
    # the active items, which any bound at or above that count leaves the same
    return next_pow2(int(g.bucket_count.max()), lo=1)


def stream_property():
    """PropertySpec: the live global triangle count (a 0-d int64 tensor)
    over the SYMMETRIC view.

    Insert-only epochs advance by ``triangles_incremental`` over the edges
    the symmetric view actually gained; delete-only epochs by
    ``triangles_decremental`` over what it lost.  Mixed epochs (deletes
    apply before inserts, so neither one-sided formula sees the right
    intermediate graph) and epochs touching self-loops recount; maintenance
    epochs keep the count (the edge set is untouched).

    A forward edge changes the symmetric view only when its reverse is not
    also stored: a gained (s, d) is an undirected gain iff (d, s) was absent
    before the batch (present now means it pre-existed, or was co-inserted,
    which ``pair_duplicated`` detects); a deleted (s, d) is an undirected
    loss iff (d, s) is absent after it.  Canonical (lo, hi) dedup then
    collapses co-updated orientation twins to one pair.

    Self-loops anywhere in the graph break the Σ|N(u) ∩ N(v)| = 6T algebra,
    so deltas are trusted only while the graph is loop-free AND the batch
    touches no loop; otherwise the epoch recounts.  The loop scan is one
    (i, i) probe over V, memoized per store version.
    """
    from ..kernels.slab_update import query_edges
    from ..stream.properties import PropertySpec

    loop_memo = {"version": None, "present": False}

    def _has_loops(store):
        if loop_memo["version"] != store.version:
            ii = torch.arange(store.n_vertices, dtype=torch.int32,
                              device=store.device)
            loop_memo["present"] = bool(
                query_edges(store.forward, ii, ii).any())
            loop_memo["version"] = store.version
        return loop_memo["present"]

    def _refresh(store):
        g = store.symmetric
        if g is None:
            raise ValueError("triangle_stream_property needs the symmetric "
                             "view (with_symmetric=True)")
        return triangles_static(g, max_bpv=_sym_bpv(g), chunk=_STREAM_CHUNK)

    def _delta_pairs(store, src, dst, mask, *, inserts: bool):
        rev_post = query_edges(store.forward, dst, src) & mask
        first = (src.long() & _MASK32) <= (dst.long() & _MASK32)
        lo = torch.where(first, src, dst)
        hi = torch.where(first, dst, src)
        if inserts:
            rev_pre = rev_post & ~pair_duplicated(lo, hi, mask)
            changed = mask & ~rev_pre
        else:
            changed = mask & ~rev_post
        keep = dedup_canonical(lo, hi, changed)
        return torch.where(keep, lo, 0), torch.where(keep, hi, 0), keep

    def _on_batch(store, count, batch):
        if batch.maintenance:
            return count
        has_ins = batch.n_inserted > 0
        has_del = batch.n_deleted > 0
        if not has_ins and not has_del:
            return count
        if has_ins and has_del:
            return _refresh(store)
        if has_ins:
            src, dst, mask = batch.ins_src, batch.ins_dst, batch.ins_mask
        else:
            src, dst, mask = batch.del_src, batch.del_dst, batch.del_mask
        if bool((mask & (src == dst)).any()) or _has_loops(store):
            return _refresh(store)       # self-loops break the 6T algebra
        lo, hi, keep = _delta_pairs(store, src, dst, mask, inserts=has_ins)
        g = store.symmetric
        gb = batch_graph(store.n_vertices, lo, hi, keep)
        kw = dict(max_bpv=_sym_bpv(g), batch_bpv=1)
        if has_ins:
            return count + triangles_incremental(g, gb, lo, hi, keep, **kw)
        return count - triangles_decremental(g, gb, lo, hi, keep, **kw)

    # an int64 total where the reference keeps a wrapping int32 one: a
    # reference checkpoint's total is widened on restore
    return PropertySpec(name="triangles", init=_refresh, on_batch=_on_batch,
                        refresh=_refresh,
                        state_like=lambda n: torch.zeros(
                            (), dtype=torch.int64))
