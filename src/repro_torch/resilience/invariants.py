"""Pool invariant audits: structural health checks on the slab pools.

Epoch after epoch the engine mutates the pools in place with nothing
re-validating them; a kernel fault (or a corrupted bit of state) would
spread until an oracle test happened to notice.  This module makes the
well-formedness contract checkable on demand and on a cadence
(``AuditPolicy(every=N)``: the store audits every N closed epochs):

* **chains** - every ``next_slab`` pointer lands in ``[-1, S)``; the
  chains from the bucket heads end within ``S`` steps (no cycle); every
  chained slab is allocated and owned by its bucket's vertex;
* **degrees** - per-vertex live-lane counts equal ``degree`` and sum to
  ``n_edges``;
* **free list** - ``free_list[:free_top]`` is in range, unique,
  unallocated and disjoint from every live chain;
* **cross-view** - the forward view's live edge multiset equals the
  transpose view's with (src, dst) swapped, by an order-independent hash
  (a wrapping sum of splitmix64), and the symmetric view holds the union
  of both directions.

The checks run as torch ops on the graph's device; the keys stay int32 bit
patterns and a lane is live where ``is_valid_vertex`` holds (the
reference's uint32 ``key < TOMBSTONE_KEY``).  The hash runs on the host in
uint64, so it equals the reference's for the same edges.  Violations are
structured (:class:`Violation`), mirrored into ``obs`` events and the
store's bounded ``audit_events``; ``AuditPolicy(fail_fast=True)`` raises
:class:`InvariantViolationError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.hashing import is_valid_vertex


@dataclasses.dataclass(frozen=True)
class Violation:
    view: str
    check: str
    detail: str
    count: int = 1

    def as_event(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class InvariantReport:
    version: int
    views: Tuple[str, ...]
    checks_run: int
    violations: Tuple[Violation, ...]
    duration_s: float

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_event(self) -> dict:
        return {"version": self.version, "views": list(self.views),
                "checks_run": self.checks_run, "ok": self.ok,
                "violations": [v.as_event() for v in self.violations],
                "duration_s": self.duration_s}


class InvariantViolationError(Exception):
    def __init__(self, report: InvariantReport):
        self.report = report
        bits = "; ".join(f"{v.view}/{v.check}: {v.detail}"
                         for v in report.violations[:4])
        more = len(report.violations) - 4
        super().__init__(
            f"pool invariants violated at version {report.version}: {bits}"
            + (f" (+{more} more)" if more > 0 else ""))


@dataclasses.dataclass(frozen=True)
class AuditPolicy:
    """When to audit and how hard to react."""
    every: int = 0                 # audit every N closed epochs (0 = never)
    fail_fast: bool = False        # violations raise instead of just logging
    cross_view: bool = True        # include the edge-multiset checks
    views: Optional[Sequence[str]] = None   # None = every live view


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser over uint64."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _live_lanes(g) -> torch.Tensor:
    return (g.slab_vertex >= 0)[:, None] & is_valid_vertex(g.keys)


def _live_edges_dev(g, *, shard: int = 0, n_shards: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) int64 on the graph's device: every live lane, src made
    global (local owner ``v`` on shard ``k`` is ``v * n_shards + k``), dst
    the uint32 key."""
    rows, lanes = torch.nonzero(_live_lanes(g), as_tuple=True)
    return (g.slab_vertex[rows].long() * n_shards + shard,
            g.keys[rows, lanes].long() & 0xFFFFFFFF)


def live_edges(g, *, shard: int = 0, n_shards: int = 1
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) of every live lane, as host uint64 (dst the uint32 key);
    a shard's local owner ``v`` on shard ``k`` is global
    ``v * n_shards + k``."""
    return tuple(a.cpu().numpy().astype(np.uint64)
                 for a in _live_edges_dev(g, shard=shard, n_shards=n_shards))


def edge_multiset_hash(src, dst, *, swap: bool = False) -> int:
    """Order-independent hash of the (src, dst) edge multiset: the wrapping
    uint64 sum of splitmix64 over ``src << 32 | dst``.  Host arrays or
    tensors of uint32 values (or int32 bit patterns)."""
    src, dst = (np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor)
                           else a) for a in (src, dst))
    if swap:
        src, dst = dst, src
    mask = np.uint64(0xFFFFFFFF)
    key = ((src.astype(np.int64).astype(np.uint64) & mask) << np.uint64(32)) \
        | (dst.astype(np.int64).astype(np.uint64) & mask)
    with np.errstate(over="ignore"):
        return int(_splitmix64(key).sum(dtype=np.uint64))


def audit_graph(g, *, view: str = "forward") -> List[Violation]:
    """The chain, degree and free-list checks on one SlabGraph."""
    out: List[Violation] = []
    nxt, sv = g.next_slab, g.slab_vertex
    S, dev = g.capacity_slabs, g.device

    # -- chain pointers in range ------------------------------------------
    bad_ptr = (nxt < -1) | (nxt >= S)
    n_bad = int(bad_ptr.sum())
    if n_bad:
        out.append(Violation(view, "chain_pointer_range",
                             f"next_slab outside [-1, {S})", n_bad))
        nxt = torch.where(bad_ptr, -1, nxt)   # clamp so the walk goes on

    # -- bounded walk from every bucket head: cycles and ownership --------
    # (the chains still walking, compacted after every step)
    visited = torch.zeros(S, dtype=torch.bool, device=dev)
    cur = torch.arange(g.n_buckets, device=dev)
    owner = g.bucket_vertex
    own_bad = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0
    while cur.numel() and steps <= S:
        visited[cur] = True
        own_bad += (sv[cur] != owner).sum()
        nv = nxt[cur]
        keep = nv >= 0
        cur, owner = nv[keep].long(), owner[keep]
        steps += 1
    if cur.numel():
        out.append(Violation(view, "chain_cycle",
                             f"{cur.numel()} chains still walking after "
                             f"{S} steps (cycle)", cur.numel()))
    if int(own_bad):
        out.append(Violation(view, "chain_ownership",
                             "chained slab owned by a different vertex "
                             "than its bucket", int(own_bad)))
    dangling = int((visited & (sv < 0)).sum())
    if dangling:
        out.append(Violation(view, "chain_unallocated",
                             "live chain reaches an unallocated slab",
                             dangling))

    # -- degree and n_edges consistency -----------------------------------
    per_slab = _live_lanes(g).sum(dim=1)
    alloc = sv >= 0
    per_vertex = torch.zeros(g.n_vertices, dtype=torch.int64, device=dev) \
        .index_add_(0, sv[alloc].long(), per_slab[alloc])
    mism = per_vertex != g.degree.long()
    n_mism = int(mism.sum())
    if n_mism:
        v0 = int(torch.nonzero(mism)[0, 0])
        out.append(Violation(view, "degree_mismatch",
                             f"live lanes != degree for {n_mism} vertices "
                             f"(e.g. v{v0}: {int(per_vertex[v0])} vs "
                             f"{int(g.degree[v0])})", n_mism))
    live_total = int(per_vertex.sum())
    n_edges = int(g.n_edges)
    if live_total != n_edges:
        out.append(Violation(view, "n_edges_mismatch",
                             f"{live_total} live lanes vs "
                             f"n_edges={n_edges}"))

    # -- free list: in range, unique, unallocated, off every chain --------
    fl = g.free_list[:int(g.free_top)].long()
    bad = (fl < 0) | (fl >= S)
    n_bad = int(bad.sum())
    if n_bad:
        out.append(Violation(view, "free_list_range",
                             f"free ids outside [0, {S})", n_bad))
        fl = fl[~bad]
    n_unique = torch.unique(fl).numel()
    if n_unique != fl.numel():
        out.append(Violation(view, "free_list_dup",
                             "duplicate ids on the free list",
                             fl.numel() - n_unique))
    realloc = int((sv[fl] >= 0).sum())
    if realloc:
        out.append(Violation(view, "free_list_allocated",
                             "free-list slab still allocated", realloc))
    in_chain = int(visited[fl].sum())
    if in_chain:
        out.append(Violation(view, "free_list_in_chain",
                             "free-list slab reachable from a live chain",
                             in_chain))
    return out


def _store_edges(store, view: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global live (src, dst) of one view of either store kind, int64 on
    the store's device."""
    g = store.views[view]
    if hasattr(g, "n_shards"):           # ShardedSlabGraph
        from ..distributed.sharded_graph import shard_slice
        parts = [_live_edges_dev(shard_slice(g, k), shard=k,
                                 n_shards=g.n_shards)
                 for k in range(g.n_shards)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return _live_edges_dev(g)


def _union_mismatch(f_src, f_dst, s_src, s_dst):
    """``(symmetric edges, union edges, size of their symmetric
    difference)``, or None when the symmetric view holds exactly the union
    of both directions of the forward one.  Sets of ``src << 32 | dst``
    keys, deduplicated and compared on the device."""
    union = torch.unique(torch.cat([(f_src << 32) | f_dst,
                                    (f_dst << 32) | f_src]))
    sym = torch.unique((s_src << 32) | s_dst)
    if union.numel() == sym.numel() and torch.equal(union, sym):
        return None
    _, counts = torch.unique(torch.cat([union, sym]), return_counts=True)
    return sym.numel(), union.numel(), int((counts == 1).sum())


def audit_store(store, *, views: Optional[Sequence[str]] = None,
                cross_view: bool = True) -> InvariantReport:
    """Run every invariant over ``views`` (default: every live view) of a
    GraphStore or a ShardedGraphStore (each shard audited on its own, its
    violations tagged ``view[k]``)."""
    t0 = time.perf_counter()
    names = tuple(views) if views else tuple(store.views)
    violations: List[Violation] = []
    checks = 0
    for name in names:
        g = store.views[name]
        if hasattr(g, "n_shards"):
            from ..distributed.sharded_graph import shard_slice
            for k in range(g.n_shards):
                violations += [dataclasses.replace(v, view=f"{name}[{k}]")
                               for v in audit_graph(shard_slice(g, k),
                                                    view=name)]
                checks += 6
        else:
            violations += audit_graph(g, view=name)
            checks += 6

    if cross_view and "forward" in names:
        f_src, f_dst = _store_edges(store, "forward")
        if "transpose" in names:
            t_src, t_dst = _store_edges(store, "transpose")
            checks += 1
            if edge_multiset_hash(t_src, t_dst, swap=True) != \
                    edge_multiset_hash(f_src, f_dst):
                violations.append(Violation(
                    "transpose", "edge_multiset",
                    "transpose edge multiset != swapped forward multiset"))
        if "symmetric" in names:
            s_src, s_dst = _store_edges(store, "symmetric")
            checks += 1
            bad = _union_mismatch(f_src, f_dst, s_src, s_dst)
            if bad is not None:
                n_sym, n_union, n_xor = bad
                violations.append(Violation(
                    "symmetric", "union_mismatch",
                    f"symmetric view has {n_sym} edges vs the "
                    f"{n_union}-edge union of both directions", n_xor))

    report = InvariantReport(
        version=store.version, views=names, checks_run=checks,
        violations=tuple(violations),
        duration_s=time.perf_counter() - t0)
    for v in violations:
        obs.emit_event("invariant_violation", version=store.version,
                       **v.as_event())
        obs.inc("invariants.violations")
    obs.inc("invariants.audits")
    return report
