"""GraphStore: the versioned multi-view update plane of the serving loop.

The store holds the forward, transpose and symmetric ``SlabGraph`` views as
one versioned unit.  Per ``apply(inserts, deletes)``:

  1. the raw batch is validated (``validate_batch``), then canonicalised
     once on the host (``canonical_batch``: dedup both halves, pad to a
     power-of-two lane count); the transpose and symmetric batches derive
     from it on the device,
  2. every view grows to hold the batch (``p + 64`` slabs for ``p`` insert
     lanes, ``2p + 64`` on the symmetric view),
  3. deletes apply before inserts, through one ``update_views`` call,
  4. out-degrees stay on the device (``out_degree`` is the forward view's
     ``degree``),
  5. listeners (the property registry) are notified while the epoch is
     open; then every view's epoch closes (``update_slab_pointers``),
  6. a bounded log of applied batches serves lazy catch-up,
  7. with a ``MaintenancePolicy`` attached, the closed epoch is checked and,
     on a trigger, every view compacts or reclaims as one versioned unit: a
     ``maintenance=True`` batch bumps the version and notifies listeners,
     and vertex-keyed property states stay valid.

The views mutate in place: a ``SlabGraph`` read from ``store.forward`` is
valid until the next ``apply``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.batch import query_edges, update_views
from ..core.device import resolve_device
from ..core.hashing import INVALID_VERTEX, as_key_bits
from ..core.slab_graph import (SlabGraph, ensure_capacity, from_edges_host,
                               next_pow2, pool_stats, update_slab_pointers)
from ..core.worklist import EdgeFrontier, expand_vertices
from ..kernels.slab_compact import compact, reclaim_free_slabs
from ..resilience.guard import validate_batch

FORWARD = "forward"
TRANSPOSE = "transpose"
SYMMETRIC = "symmetric"
ALL_VIEWS = (FORWARD, TRANSPOSE, SYMMETRIC)


def _pad_ids(a: np.ndarray, n: int, device) -> torch.Tensor:
    out = np.full(n, INVALID_VERTEX, np.int32)
    out[:len(a)] = as_key_bits(a)
    return torch.from_numpy(out).to(device)


def _pad_f32(a: Optional[np.ndarray], n: int, device
             ) -> Optional[torch.Tensor]:
    if a is None:
        return None
    out = np.zeros(n, np.float32)
    out[:len(a)] = a
    return torch.from_numpy(out).to(device)


def dedup_pairs(src, dst, w=None) -> Tuple[np.ndarray, np.ndarray,
                                           Optional[np.ndarray]]:
    """Host-side (src, dst) dedup, first occurrence wins."""
    src = np.asarray(src, dtype=np.uint32)
    dst = np.asarray(dst, dtype=np.uint32)
    w = None if w is None else np.asarray(w, dtype=np.float32)
    if len(src) == 0:
        return src, dst, w
    key = (src.astype(np.uint64) << np.uint64(32)) | dst.astype(np.uint64)
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return src[idx], dst[idx], None if w is None else w[idx]


def canonical_batch(ins_src, ins_dst, ins_w, del_src, del_dst, *,
                    weighted: bool):
    """Dedup the insert and delete halves (first occurrence wins) and
    default missing insert weights to 1 on weighted stores."""
    i_s, i_d, i_w = dedup_pairs(
        () if ins_src is None else ins_src,
        () if ins_dst is None else ins_dst, ins_w)
    d_s, d_d, _ = dedup_pairs(
        () if del_src is None else del_src,
        () if del_dst is None else del_dst)
    if weighted and len(i_s) and i_w is None:
        i_w = np.ones(len(i_s), np.float32)
    return i_s, i_d, i_w, d_s, d_d


@dataclasses.dataclass(frozen=True)
class AppliedBatch:
    """One closed update epoch as incremental maintainers see it: the padded
    device batches (int32 key bit patterns) the views were mutated with, and
    masks of the edges actually inserted into / deleted from the forward
    view.  ``ins_src is None`` means the epoch had no insert phase."""
    version: int
    ins_src: Optional[torch.Tensor]
    ins_dst: Optional[torch.Tensor]
    ins_w: Optional[torch.Tensor]
    ins_mask: Optional[torch.Tensor]
    del_src: Optional[torch.Tensor]
    del_dst: Optional[torch.Tensor]
    del_mask: Optional[torch.Tensor]
    n_inserted: int
    n_deleted: int
    #: a maintenance pass (compaction or slab reclamation): the edge set is
    #: unchanged, vertex-keyed property states stay valid and replay skips
    #: it; only slab handles kept from before are stale
    maintenance: bool = False


class VersionedStoreBase:
    """Version, bounded batch log, listeners and the maintenance plane: the
    contract the property registry's catch-up relies on (``version`` is
    monotonic, ``batches_since`` is None past the log floor, listeners run
    while the epoch is open)."""

    def __init__(self, *, version: int = 0, log_capacity: int = 64,
                 maintenance=None):
        self.version = int(version)
        self._log_capacity = int(log_capacity)
        self._log: List[AppliedBatch] = []
        self._log_floor = int(version)
        self._listeners: List[Callable[[AppliedBatch], None]] = []
        #: optional MaintenancePolicy, evaluated at every epoch close
        self.maintenance = maintenance
        self.maintenance_count = 0
        self.last_maintenance = None
        self._epochs_since_maint = 0
        #: per view, the slab reservation of the last insert epoch: a
        #: compaction keeps that much headroom, so a shrunk pool does not
        #: grow right back for the next batch of the same size
        self._last_reserve: Dict[str, int] = {}
        #: exact tombstone accounting, so the per-epoch check needs no pool
        #: scan: every recorded delete leaves one tombstone lane, and only
        #: maintenance clears them
        self._tombstone_base = 0
        self._deletes_since_maint = 0
        #: one event per maintenance pass, bounded like the batch log
        self.maintenance_events: List[dict] = []

    def add_listener(self, fn: Callable[[AppliedBatch], None]) -> None:
        """Subscribe to applied batches (called with the epoch still open)."""
        self._listeners.append(fn)

    def batches_since(self, version: int) -> Optional[List[AppliedBatch]]:
        """Applied batches after ``version``, oldest first; None when the
        bounded log no longer reaches back that far."""
        if version == self.version:
            return []
        if version < self._log_floor:
            return None
        return [b for b in self._log if b.version > version]

    def _record_batch(self, **fields) -> AppliedBatch:
        """Bump the version, log the batch, notify listeners."""
        self.version += 1
        batch = AppliedBatch(version=self.version, **fields)
        self._log.append(batch)
        if len(self._log) > self._log_capacity:
            self._log = self._log[-self._log_capacity:]
            self._log_floor = self._log[0].version - 1
        if not batch.maintenance:
            self._deletes_since_maint += batch.n_deleted
        for fn in self._listeners:
            fn(batch)
        return batch

    # ----------------------------------------------------- maintenance plane
    def _maintain_views(self, action: str, policy, *, shrink: bool):
        """Apply one maintenance action to every view; ``(reports,
        reclaimed)`` keyed by view name."""
        reports: Dict[str, object] = {}
        reclaimed: Dict[str, int] = {}
        if action == "compact":
            for name in list(self._views):
                slack = max(policy.slack_slabs,
                            self._last_reserve.get(name, 0))
                self._views[name], reports[name] = compact(
                    self._views[name], shrink=shrink, slack_slabs=slack)
        elif action == "reclaim":
            for name in list(self._views):
                self._views[name], reclaimed[name] = reclaim_free_slabs(
                    self._views[name])
        else:
            raise ValueError(f"unknown maintenance action {action!r}")
        return reports, reclaimed

    def _cheap_stats(self) -> dict:
        """``pool_stats`` for the triggers that need no pool scan.  The
        tombstone count is exact; the fields only a scan gives hold values
        that never trigger (a policy arming those triggers scans)."""
        tombs = self._tombstone_base + self._deletes_since_maint
        live = int(self.n_edges)
        return {"tombstone_ratio": tombs / max(1, tombs + live),
                "tombstone_lanes": tombs,
                "mean_chain": 0.0, "occupancy": 1.0, "dead_slabs": 0}

    def _auto_maintain(self) -> None:
        """Epoch-close hook: count the epoch, run the policy if present."""
        self._epochs_since_maint += 1
        if self.maintenance is not None:
            self.maintain()

    def maintain(self, action: Optional[str] = None):
        """Run pool maintenance over every view as one versioned unit.

        With ``action=None`` the store's policy decides, from the delete
        accounting when only the tombstone and ``every`` triggers are armed
        and from a forward-view ``pool_stats`` scan otherwise, and nothing
        happens (None) without a trigger.  ``action="compact"`` or
        ``"reclaim"`` forces that tier.  On action every view maintains,
        the version bumps and listeners see a ``maintenance=True`` batch.
        Returns the ``MaintenanceRecord``.

        The scan that follows a decision reads lanes only: the shrink test
        and the record need no chain lengths, whose walk would sync once
        per hop of the longest chain.
        """
        from .maintenance import MaintenancePolicy, MaintenanceRecord

        policy = self.maintenance or MaintenancePolicy()
        needs_scan = bool(policy.max_mean_chain or policy.min_occupancy
                          or policy.reclaim_dead_slabs)
        trigger = "forced"
        t_scan = time.perf_counter()
        if action is None:
            stats = (self.pool_stats(chains=bool(policy.max_mean_chain))
                     if needs_scan else self._cheap_stats())
            decision = policy.decide(
                stats, epochs_since=self._epochs_since_maint)
            if decision is None:
                return None
            action, trigger = decision
            if not needs_scan:           # a trigger fired: scan for shrink
                stats = self.pool_stats(chains=False)
        else:
            stats = self.pool_stats(chains=False)
        scan_s = time.perf_counter() - t_scan
        t0 = time.perf_counter()
        reports, reclaimed = self._maintain_views(
            action, policy, shrink=policy.allow_shrink(stats))
        self._epochs_since_maint = 0
        self._deletes_since_maint = 0
        # compaction drops every tombstone; reclamation frees only wholly
        # dead slabs, so keep the (pre-pass, thus conservative) count
        self._tombstone_base = (0 if action == "compact"
                                else stats["tombstone_lanes"])
        batch = self._record_batch(
            ins_src=None, ins_dst=None, ins_w=None, ins_mask=None,
            del_src=None, del_dst=None, del_mask=None,
            n_inserted=0, n_deleted=0, maintenance=True)
        fwd = reports.get(FORWARD)
        cap = int(stats.get("capacity_slabs", 0))
        record = MaintenanceRecord(
            version=batch.version, action=action, trigger=trigger,
            reports=reports, reclaimed=reclaimed,
            duration_s=time.perf_counter() - t0, scan_s=scan_s,
            tombstone_ratio=float(stats["tombstone_ratio"]),
            capacity_before=fwd.old_capacity if fwd else cap,
            capacity_after=fwd.new_capacity if fwd else cap,
            slabs_reclaimed=sum(reclaimed.values()))
        self.maintenance_count += 1
        self.last_maintenance = record
        self.maintenance_events.append(record.as_event())
        if len(self.maintenance_events) > self._log_capacity:
            self.maintenance_events = \
                self.maintenance_events[-self._log_capacity:]
        return record


class GraphStore(VersionedStoreBase):
    """Forward, transpose and symmetric SlabGraph views as one versioned
    unit, on one device."""

    def __init__(self, views: Dict[str, SlabGraph], *, weighted: bool,
                 version: int = 0, log_capacity: int = 64,
                 maintenance=None):
        if FORWARD not in views:
            raise ValueError("a GraphStore always carries the forward view")
        unknown = set(views) - set(ALL_VIEWS)
        if unknown:
            raise ValueError(f"unknown views {unknown}")
        super().__init__(version=version, log_capacity=log_capacity,
                         maintenance=maintenance)
        self._views = dict(views)
        self.weighted = bool(weighted)
        self.device = views[FORWARD].device
        self._max_bpv = (int(views[FORWARD].bucket_count.max())
                         if views[FORWARD].n_vertices else 1)

    @classmethod
    def from_edges(cls, n_vertices: int, src, dst, w=None, *,
                   hashing: bool = False, load_factor: float = 0.7,
                   slack_slabs: int = 0, with_transpose: bool = True,
                   with_symmetric: bool = True, log_capacity: int = 64,
                   maintenance=None, device="cuda") -> "GraphStore":
        """Bulk-build every view from one host edge list (dedup shared).
        Runs on ``cuda`` unless ``device="cpu"``; raises without a card."""
        dev = resolve_device(device)
        src, dst, w = dedup_pairs(src, dst, w)
        kw = dict(hashing=hashing, load_factor=load_factor,
                  slack_slabs=slack_slabs, device=dev)
        views = {FORWARD: from_edges_host(n_vertices, src, dst, w, **kw)}
        if with_transpose:
            views[TRANSPOSE] = from_edges_host(n_vertices, dst, src, w, **kw)
        if with_symmetric:
            w2 = None if w is None else np.concatenate([w, w])
            views[SYMMETRIC] = from_edges_host(
                n_vertices, np.concatenate([src, dst]),
                np.concatenate([dst, src]), w2, **kw)
        return cls(views, weighted=w is not None, log_capacity=log_capacity,
                   maintenance=maintenance)

    # ------------------------------------------------------------- accessors
    @property
    def forward(self) -> SlabGraph:
        return self._views[FORWARD]

    @property
    def transpose(self) -> Optional[SlabGraph]:
        return self._views.get(TRANSPOSE)

    @property
    def symmetric(self) -> Optional[SlabGraph]:
        return self._views.get(SYMMETRIC)

    @property
    def views(self) -> Dict[str, SlabGraph]:
        return dict(self._views)

    @property
    def n_vertices(self) -> int:
        return self.forward.n_vertices

    @property
    def n_edges(self) -> int:
        return int(self.forward.n_edges)

    @property
    def out_degree(self) -> torch.Tensor:
        """Out-degrees on the device: the forward view's ``degree``."""
        return self.forward.degree

    # ----------------------------------------------------------------- apply
    def apply(self, ins_src=None, ins_dst=None, ins_w=None,
              del_src=None, del_dst=None) -> AppliedBatch:
        """Apply one mixed batch to every view and close the epoch.

        Deletes apply first, then inserts; weighted stores default missing
        insert weights to 1.  Then the maintenance policy, if any, checks
        the closed epoch.  Returns the ``AppliedBatch`` (also logged).
        """
        validate_batch(ins_src, ins_dst, ins_w, del_src, del_dst,
                       n_vertices=self.n_vertices)
        i_s, i_d, i_w, d_s, d_d = canonical_batch(
            ins_src, ins_dst, ins_w, del_src, del_dst,
            weighted=self.weighted)
        roles = tuple(v for v in ALL_VIEWS if v in self._views)

        if len(i_s):
            # an insert lane opens at most one slab
            p = next_pow2(len(i_s))
            for name in roles:
                need = 2 * p + 64 if name == SYMMETRIC else p + 64
                self._views[name] = ensure_capacity(self._views[name], need)
                self._last_reserve[name] = need

        dels = ins = None
        del_sj = del_dj = ins_sj = ins_dj = ins_wj = None
        if len(d_s):
            p = next_pow2(len(d_s))
            del_sj = _pad_ids(d_s, p, self.device)
            del_dj = _pad_ids(d_d, p, self.device)
            dels = (del_sj, del_dj)
        if len(i_s):
            p = next_pow2(len(i_s))
            ins_sj = _pad_ids(i_s, p, self.device)
            ins_dj = _pad_ids(i_d, p, self.device)
            ins_wj = _pad_f32(i_w, p, self.device)
            ins = (ins_sj, ins_dj, ins_wj)

        ins_mask = del_mask = None
        n_inserted = n_deleted = 0
        if ins is not None or dels is not None:
            new_views, ins_mask, del_mask = update_views(
                tuple(self._views[r] for r in roles), roles, ins, dels)
            for r, g in zip(roles, new_views):
                self._views[r] = g
            if del_mask is not None:
                n_deleted = int(del_mask.sum())
            if ins_mask is not None:
                n_inserted = int(ins_mask.sum())

        batch = self._record_batch(
            ins_src=ins_sj, ins_dst=ins_dj, ins_w=ins_wj, ins_mask=ins_mask,
            del_src=del_sj, del_dst=del_dj, del_mask=del_mask,
            n_inserted=n_inserted, n_deleted=n_deleted)
        for name, g in self._views.items():
            self._views[name] = update_slab_pointers(g)
        self._auto_maintain()
        return batch

    # --------------------------------------------------------------- queries
    def pool_stats(self, view: str = FORWARD, *, chains: bool = True
                   ) -> dict:
        """Pool-health snapshot of one view (``core.pool_stats``)."""
        return pool_stats(self._views[view], chains=chains)

    def query(self, src, dst) -> np.ndarray:
        """Batched edge membership against the forward view (host arrays in,
        host bool array out, trimmed to the query length)."""
        src = np.asarray(src, np.uint32)
        dst = np.asarray(dst, np.uint32)
        p = next_pow2(max(len(src), 1))
        found = query_edges(self.forward, _pad_ids(src, p, self.device),
                            _pad_ids(dst, p, self.device))
        return found.cpu().numpy()[:len(src)]

    def neighbors(self, vertices, *, out_capacity: int = 4096
                  ) -> EdgeFrontier:
        """Current out-edges of ``vertices`` (forward view)."""
        vertices = np.asarray(vertices, np.uint32)
        p = next_pow2(max(len(vertices), 1))
        vmask = torch.from_numpy(np.arange(p) < len(vertices)).to(
            self.device)
        return expand_vertices(self.forward,
                               _pad_ids(vertices, p, self.device), vmask,
                               out_capacity=next_pow2(out_capacity),
                               max_bpv=self._max_bpv)
