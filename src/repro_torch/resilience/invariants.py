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
from ..core.hashing import TOMBSTONE_KEY, is_valid_vertex


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


def _union_mismatch(union_keys, sym_keys):
    """``(symmetric edges, union edges, size of their symmetric
    difference)`` of two sets of ``src << 32 | dst`` keys (each may hold
    repeats), deduplicated and compared on the device; the last count is
    0 exactly when the symmetric view holds the union of both directions
    of the forward one."""
    union, sym = torch.unique(union_keys), torch.unique(sym_keys)
    if union.numel() == sym.numel() and torch.equal(union, sym):
        return sym.numel(), union.numel(), 0
    _, counts = torch.unique(torch.cat([union, sym]), return_counts=True)
    return sym.numel(), union.numel(), int((counts == 1).sum())


def _keys(src, dst):
    return (src << 32) | dst


def _cross_view_violations(transpose_hashes, union_counts
                           ) -> List[Violation]:
    """The cross-view checks' violations from ``(transpose hash, swapped
    forward hash)`` and ``(symmetric, union, difference)`` counts (None for
    a check not run)."""
    out: List[Violation] = []
    if transpose_hashes is not None and \
            transpose_hashes[0] != transpose_hashes[1]:
        out.append(Violation(
            "transpose", "edge_multiset",
            "transpose edge multiset != swapped forward multiset"))
    if union_counts is not None and union_counts[2]:
        n_sym, n_union, n_xor = union_counts
        out.append(Violation(
            "symmetric", "union_mismatch",
            f"symmetric view has {n_sym} edges vs the "
            f"{n_union}-edge union of both directions", n_xor))
    return out


def _gather_keys(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's 1-D int64 ``x`` (lengths may differ), concatenated in
    rank order on every rank."""
    from ..distributed.collectives import gather_objects, gather_stacked
    sizes = gather_objects(int(x.numel()), group)
    padded = x.new_zeros(max(sizes))
    padded[:x.numel()] = x
    parts = gather_stacked(padded, group)
    return torch.cat([parts[r, :n] for r, n in enumerate(sizes)])


def _audit_mesh(store, names: Tuple[str, ...], cross_view: bool,
                t0: float) -> Tuple[int, List[Violation], float]:
    """A mesh store's audit, the same on every rank and the stacked
    store's, violation for violation: each rank audits its own shard and
    the violations are gathered in shard order; the transpose check sums
    the ranks' wrapping hashes; the symmetric check compares on each rank
    the union keys whose source it owns (its forward edges, and the
    reversed forward edges of every rank, all-gathered) with its symmetric
    shard, and sums the counts."""
    from ..distributed.collectives import gather_objects
    from ..distributed.sharded_graph import shard_slice
    sg0 = store.views[names[0]]
    group, me, S = sg0.group, sg0.rank, sg0.n_shards
    mine = {name: [dataclasses.replace(v, view=f"{name}[{me}]")
                   for v in audit_graph(shard_slice(store.views[name], me),
                                        view=name)]
            for name in names}
    hashes = counts = None
    if cross_view and "forward" in names:
        def edges(view):
            return _live_edges_dev(shard_slice(store.views[view], me),
                                   shard=me, n_shards=S)
        f_src, f_dst = edges("forward")
        if "transpose" in names:
            hashes = (edge_multiset_hash(*edges("transpose"), swap=True),
                      edge_multiset_hash(f_src, f_dst))
        if "symmetric" in names:
            rev = _gather_keys(_keys(f_dst, f_src), group)
            rev = rev[(rev >> 32) % S == me]
            union = torch.cat([_keys(f_src, f_dst), rev])
            del rev
            counts = _union_mismatch(union, _keys(*edges("symmetric")))
            del union
    parts = gather_objects((mine, hashes, counts,
                            time.perf_counter() - t0), group)
    violations = [v for name in names for part in parts
                  for v in part[0][name]]
    summed = None
    if hashes is not None:
        summed = tuple(sum(p[1][i] for p in parts) % (1 << 64)
                       for i in range(2))
    total = None
    if counts is not None:
        total = tuple(sum(p[2][i] for p in parts) for i in range(3))
    violations += _cross_view_violations(summed, total)
    checks = 6 * S * len(names) + (hashes is not None) + (counts is not None)
    return checks, violations, max(p[3] for p in parts)


def audit_store(store, *, views: Optional[Sequence[str]] = None,
                cross_view: bool = True) -> InvariantReport:
    """Run every invariant over ``views`` (default: every live view) of a
    GraphStore or a ShardedGraphStore (each shard audited on its own, its
    violations tagged ``view[k]``).  On a mesh every rank calls it and
    gets the same report, the stacked store's (its ``duration_s`` the
    slowest rank's)."""
    t0 = time.perf_counter()
    names = tuple(views) if views else tuple(store.views)
    if getattr(store.views[names[0]], "mesh", None) is not None:
        checks, violations, duration = _audit_mesh(store, names,
                                                   cross_view, t0)
    else:
        violations: List[Violation] = []
        checks = 0
        for name in names:
            g = store.views[name]
            if hasattr(g, "n_shards"):
                from ..distributed.sharded_graph import shard_slice
                for k in range(g.n_shards):
                    violations += [
                        dataclasses.replace(v, view=f"{name}[{k}]")
                        for v in audit_graph(shard_slice(g, k), view=name)]
                    checks += 6
            else:
                violations += audit_graph(g, view=name)
                checks += 6
        hashes = counts = None
        if cross_view and "forward" in names:
            f_src, f_dst = _store_edges(store, "forward")
            if "transpose" in names:
                checks += 1
                hashes = (edge_multiset_hash(*_store_edges(store,
                                                           "transpose"),
                                             swap=True),
                          edge_multiset_hash(f_src, f_dst))
            if "symmetric" in names:
                checks += 1
                counts = _union_mismatch(
                    torch.cat([_keys(f_src, f_dst), _keys(f_dst, f_src)]),
                    _keys(*_store_edges(store, "symmetric")))
        violations += _cross_view_violations(hashes, counts)
        duration = time.perf_counter() - t0

    report = InvariantReport(
        version=store.version, views=names, checks_run=checks,
        violations=tuple(violations), duration_s=duration)
    for v in violations:
        obs.emit_event("invariant_violation", version=store.version,
                       **v.as_event())
        obs.inc("invariants.violations")
    obs.inc("invariants.audits")
    return report
