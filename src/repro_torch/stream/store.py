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

Resilience plane (all opt-in): the raw batch is validated at admission;
with a ``WriteAheadLog`` attached the canonical batch is journaled (fsync)
before the engine runs, and rolled back if the apply then fails short of a
simulated kill; capacity growth runs under a ``RetryBudget``; every phase
carries a named fault point and a flight-recorder event; an
``AuditPolicy`` audits the pools on its cadence; ``save``/``restore``
checkpoint the views, the property states and the maintenance counters,
so ``resilience.recover`` (restore plus WAL replay) re-derives the crashed
process's trajectory bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.batch import query_edges, update_views
from ..core.device import resolve_device
from ..core.hashing import INVALID_VERTEX, as_key_bits
from ..core.slab_graph import (FIELDS, SlabGraph, ensure_capacity,
                               from_edges_host, next_pow2, pool_stats,
                               update_slab_pointers)
from ..core.worklist import EdgeFrontier, expand_vertices
from ..kernels.slab_compact import compact, reclaim_free_slabs
from ..obs import flight as _flight
from ..resilience import faults
from ..resilience.guard import RetryBudget, run_with_retries, validate_batch

FORWARD = "forward"
TRANSPOSE = "transpose"
SYMMETRIC = "symmetric"
ALL_VIEWS = (FORWARD, TRANSPOSE, SYMMETRIC)

# flight-recorder codes: each apply phase writes one ring event even with
# tracing and metrics off, so a post-mortem shows the last phase cleared
_FL_ADMIT = _flight.intern("store.apply.admitted")
_FL_GROW = _flight.intern("store.capacity_grow")
_FL_POST_WAL = _flight.intern("store.apply.post_wal")
_FL_DISPATCH = _flight.intern("store.apply.dispatch")
_FL_CLOSE = _flight.intern("store.apply.close")
_FL_MAINTAIN = _flight.intern("store.maintain")


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
        #: live edges on the host, primed by one read and then kept by the
        #: batch log, so ``_cheap_stats`` never waits for the device
        self._n_edges_host: Optional[int] = None
        #: one event per maintenance pass, bounded like the batch log
        self.maintenance_events: List[dict] = []
        #: optional WriteAheadLog: every apply journals its canonical batch
        #: (fsync) before the engine runs
        self.wal = None
        #: optional AuditPolicy: pool invariant audits every N epochs
        self.audits = None
        self._epochs_since_audit = 0
        #: InvariantReport events, bounded like the batch log
        self.audit_events: List[dict] = []
        #: bounded retries of capacity growth
        self.retry = RetryBudget()

    # ----------------------------------------------------- resilience plane
    def attach_wal(self, wal) -> "VersionedStoreBase":
        """Journal every applied batch through ``wal``; with ``save`` and
        ``resilience.recover`` a crash recovers exactly.  Returns self."""
        self.wal = wal
        return self

    def attach_audits(self, policy) -> "VersionedStoreBase":
        """Audit the pools on the policy's cadence.  Returns self."""
        self.audits = policy
        return self

    def _wal_append(self, i_s, i_d, i_w, d_s, d_d):
        """Journal the canonical batch for version + 1 (the version
        ``_record_batch`` will assign); the rollback token, or None
        without a WAL."""
        if self.wal is None:
            return None
        with obs.span("store.apply.wal", version=self.version):
            token = self.wal.append(self.version + 1, i_s, i_d, i_w,
                                    d_s, d_d)
        obs.inc("store.wal.appends")
        return token

    def audit(self, *, views=None, cross_view: bool = True):
        """Run the pool invariant audit now; the ``InvariantReport`` (also
        appended to ``audit_events``)."""
        from ..resilience.invariants import audit_store
        report = audit_store(self, views=views, cross_view=cross_view)
        self.audit_events.append(report.as_event())
        if len(self.audit_events) > self._log_capacity:
            self.audit_events = self.audit_events[-self._log_capacity:]
        return report

    def _auto_audit(self) -> None:
        """Epoch-close hook: audit on the AuditPolicy's cadence."""
        if self.audits is None or not self.audits.every:
            return
        self._epochs_since_audit += 1
        if self._epochs_since_audit < self.audits.every:
            return
        self._epochs_since_audit = 0
        report = self.audit(views=self.audits.views,
                            cross_view=self.audits.cross_view)
        if not report.ok and self.audits.fail_fast:
            from ..resilience.invariants import InvariantViolationError
            raise InvariantViolationError(report)

    def _dump_postmortem(self, exc: BaseException) -> None:
        """Crash hook: write the post-mortem bundle beside the WAL (never
        raises; skips the pipeline-recoverable failures)."""
        from ..obs import postmortem
        postmortem.on_apply_failure(self, exc)

    def _resilience_meta(self) -> dict:
        """The host counters a checkpoint carries, so that a recovered
        store's maintenance triggers fire as the crashed one's would."""
        return {"epochs_since_maint": int(self._epochs_since_maint),
                "deletes_since_maint": int(self._deletes_since_maint),
                "tombstone_base": int(self._tombstone_base),
                "last_reserve": {k: int(v)
                                 for k, v in self._last_reserve.items()}}

    def _adopt_resilience_meta(self, meta: dict) -> None:
        res = meta.get("resilience")
        if not res:
            return
        self._epochs_since_maint = int(res.get("epochs_since_maint", 0))
        self._deletes_since_maint = int(res.get("deletes_since_maint", 0))
        self._tombstone_base = int(res.get("tombstone_base", 0))
        self._last_reserve = {k: int(v)
                              for k, v in res.get("last_reserve",
                                                  {}).items()}

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
            if self._n_edges_host is not None:
                self._n_edges_host += batch.n_inserted - batch.n_deleted
        for fn in self._listeners:
            fn(batch)
        return batch

    # ----------------------------------------------------- maintenance plane
    def pool_stats(self, view: str = "forward") -> dict:
        """Pool-health snapshot of one view; each store kind answers."""
        raise NotImplementedError

    def _maintain_views(self, action: str, policy, *, shrink: bool):
        """Apply one maintenance action to every view; ``(reports,
        reclaimed)`` keyed by view name."""
        reports: Dict[str, object] = {}
        reclaimed: Dict[str, int] = {}
        if action == "compact":
            for name in list(self._views):
                slack = max(policy.slack_slabs,
                            self._last_reserve.get(name, 0))
                self._views[name], reports[name] = self._compact_view(
                    self._views[name], shrink=shrink, slack_slabs=slack)
        elif action == "reclaim":
            for name in list(self._views):
                self._views[name], reclaimed[name] = self._reclaim_view(
                    self._views[name])
        else:
            raise ValueError(f"unknown maintenance action {action!r}")
        return reports, reclaimed

    def _cheap_stats(self) -> dict:
        """``pool_stats`` for the triggers that need no pool scan.  The
        tombstone count is exact; the fields only a scan gives hold values
        that never trigger (a policy arming those triggers scans)."""
        tombs = self._tombstone_base + self._deletes_since_maint
        if self._n_edges_host is None:
            self._n_edges_host = int(self.n_edges)
        live = self._n_edges_host
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
        with obs.span("store.maintain", version=self.version,
                      action=action, trigger=trigger):
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
        obs.emit_event("maintenance", **record.as_event())
        obs.inc(f"store.maintain.{action}")
        _flight.record(_FL_MAINTAIN, batch.version,
                       record.slabs_reclaimed, record.capacity_after)
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

    @property
    def in_degree(self) -> torch.Tensor:
        """In-degrees on the device: the transpose view's ``degree``."""
        if self.transpose is None:
            raise ValueError("in-degrees live on the transpose view; build "
                             "the store with with_transpose=True")
        return self.transpose.degree

    @property
    def max_bpv(self) -> int:
        """The most buckets any vertex of the forward view had at build:
        the bound ``neighbors`` walks each vertex's buckets to."""
        return self._max_bpv

    # ----------------------------------------------------------------- apply
    def apply(self, ins_src=None, ins_dst=None, ins_w=None,
              del_src=None, del_dst=None) -> AppliedBatch:
        """Apply one mixed batch to every view and close the epoch.

        Deletes apply first, then inserts; weighted stores default missing
        insert weights to 1.  Then the maintenance policy, if any, checks
        the closed epoch, and the audit policy, if any, audits it.  Returns
        the ``AppliedBatch`` (also logged).

        The raw inputs are validated at admission (``QuarantinedBatch``,
        nothing moved); the canonical batch is journaled to an attached
        WAL before the engine runs; capacity growth runs under the store's
        ``RetryBudget``; the fault sites are ``apply.admitted``,
        ``store.capacity_grow``, ``apply.post_wal``, ``apply.pre_close``
        and ``apply.post_close``, in that order.
        """
        validate_batch(ins_src, ins_dst, ins_w, del_src, del_dst,
                       n_vertices=self.n_vertices)
        t0 = time.perf_counter()
        epoch_span = obs.span("store.apply", version=self.version)
        epoch_span.__enter__()
        try:
            with obs.span("store.apply.host_dedup"):
                i_s, i_d, i_w, d_s, d_d = canonical_batch(
                    ins_src, ins_dst, ins_w, del_src, del_dst,
                    weighted=self.weighted)
            faults.fault_point("apply.admitted", version=self.version)
            _flight.record(_FL_ADMIT, self.version, len(i_s), len(d_s))
            roles = tuple(v for v in ALL_VIEWS if v in self._views)

            if len(i_s):
                # an insert lane opens at most one slab
                p = next_pow2(len(i_s))

                def _grow():
                    faults.fault_point("store.capacity_grow",
                                       version=self.version)
                    for name in roles:
                        need = 2 * p + 64 if name == SYMMETRIC else p + 64
                        self._views[name] = ensure_capacity(
                            self._views[name], need)
                        self._last_reserve[name] = need
                    _flight.record(_FL_GROW, self.version, p)

                with obs.span("store.apply.capacity"):
                    run_with_retries(_grow, budget=self.retry,
                                     site="store.capacity_grow")

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

            # durability: journal the canonical batch, then run the engine
            wal_token = self._wal_append(i_s, i_d, i_w, d_s, d_d)
            faults.fault_point("apply.post_wal", version=self.version)
            _flight.record(_FL_POST_WAL, self.version,
                           0 if wal_token is None else 1)

            try:
                ins_mask = del_mask = None
                n_inserted = n_deleted = 0
                if ins is not None or dels is not None:
                    with obs.span("store.apply.dispatch",
                                  version=self.version, views=len(roles)):
                        new_views, ins_mask, del_mask = update_views(
                            tuple(self._views[r] for r in roles), roles,
                            ins, dels)
                        for r, g in zip(roles, new_views):
                            self._views[r] = g
                        if del_mask is not None:
                            n_deleted = int(del_mask.sum())
                        if ins_mask is not None:
                            n_inserted = int(ins_mask.sum())
                faults.fault_point("apply.pre_close", version=self.version)
                _flight.record(_FL_DISPATCH, self.version,
                               n_inserted, n_deleted)

                with obs.span("store.apply.notify"):
                    batch = self._record_batch(
                        ins_src=ins_sj, ins_dst=ins_dj, ins_w=ins_wj,
                        ins_mask=ins_mask, del_src=del_sj, del_dst=del_dj,
                        del_mask=del_mask, n_inserted=n_inserted,
                        n_deleted=n_deleted)
                with obs.span("store.apply.epoch_close",
                              sync=tuple(self._views.values())):
                    for name, g in self._views.items():
                        self._views[name] = update_slab_pointers(g)
                faults.fault_point("apply.post_close", version=self.version)
                _flight.record(_FL_CLOSE, batch.version,
                               n_inserted, n_deleted)
            except faults.InjectedCrash:
                raise          # a simulated kill: the WAL record survives
            except BaseException:
                # the journaled batch never applied in this process and the
                # caller sees the failure: drop the record, so that a later
                # replay does not resurrect a rejected batch
                if wal_token is not None:
                    self.wal.rollback(wal_token)
                raise
            epoch_span.annotate(inserted=n_inserted, deleted=n_deleted)
        except BaseException as e:
            # a failed apply may have moved the pools before it failed:
            # re-read the live edge count rather than trust the log's
            self._n_edges_host = None
            self._dump_postmortem(e)
            raise
        finally:
            epoch_span.__exit__(None, None, None)
        if obs.metrics.enabled():
            obs.observe("store.apply", time.perf_counter() - t0)
            obs.inc("store.apply.epochs")
            obs.inc("store.apply.inserted", n_inserted)
            obs.inc("store.apply.deleted", n_deleted)
        self._auto_maintain()
        self._auto_audit()
        return batch

    # ----------------------------------------------------- maintenance plane
    def pool_stats(self, view: str = FORWARD, *, chains: bool = True
                   ) -> dict:
        """Pool-health snapshot of one view (``core.pool_stats``)."""
        return pool_stats(self._views[view], chains=chains)

    def _compact_view(self, g: SlabGraph, *, shrink: bool, slack_slabs: int):
        return compact(g, shrink=shrink, slack_slabs=slack_slabs)

    def _reclaim_view(self, g: SlabGraph):
        return reclaim_free_slabs(g)

    # --------------------------------------------------------------- queries

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

    # ------------------------------------------------------------ checkpoint
    def save(self, ckpt_dir, step: Optional[int] = None, *, registry=None,
             extra: Optional[dict] = None, keep_last: int = 3):
        """Persist every view and the registered property states
        atomically (``checkpoint.ckpt``, the reference's format).

        The manifest's ``extra`` carries what ``restore`` needs to rebuild
        the structure: each view's bucket count, the store version, each
        property's version and the maintenance counters.  A checkpoint at
        the current version retires the WAL segments it covers."""
        from ..checkpoint import ckpt
        step = self.version if step is None else int(step)
        props = {} if registry is None else registry.states()
        prop_versions = {} if registry is None else registry.versions()
        meta = {
            "stream_store": True,
            "version": int(self.version),
            "n_vertices": int(self.n_vertices),
            "weighted": bool(self.weighted),
            "views": {name: int(g.n_buckets)
                      for name, g in self._views.items()},
            "prop_versions": {k: int(v) for k, v in prop_versions.items()},
            "resilience": self._resilience_meta(),
        }
        if extra:
            meta.update(extra)
        path = ckpt.save(ckpt_dir, step, {"views": dict(self._views),
                                          "props": props}, extra=meta,
                         keep_last=keep_last)
        if self.wal is not None and step == self.version:
            self.wal.truncate(self.version)
        return path

    @classmethod
    def restore(cls, ckpt_dir, *, step: Optional[int] = None,
                specs: Sequence = (),
                policies: Optional[Dict[str, str]] = None,
                log_capacity: int = 64, maintenance=None, device="cuda"):
        """Rebuild ``(store, registry)`` from a checkpoint on ``device``
        (``cuda`` unless the caller passes ``"cpu"``; raises without a
        card).

        ``specs`` must cover every property the checkpoint holds (their
        ``state_like`` gives the skeleton); the maintainers resume from the
        saved states and versions.  The registry is None when the
        checkpoint holds no property and no spec was given.
        ``maintenance=`` re-attaches the crashed process's policy; its
        counters come from the manifest, so a WAL replay re-derives the
        maintenance epochs exactly.  The views' skeleton is built from the
        manifest alone (dtypes, no tensors), so nothing is allocated on the
        device beyond the restored leaves.
        """
        from ..checkpoint import ckpt
        from ..checkpoint.ckpt import CheckpointError
        dev = resolve_device(device)
        manifest = ckpt.read_manifest(ckpt_dir, step=step)
        meta = manifest["extra"]
        missing = [k for k in ("n_vertices", "weighted", "views",
                               "prop_versions") if k not in meta]
        if not meta.get("stream_store") or missing:
            raise CheckpointError(
                f"{ckpt_dir} step {manifest['step']} is not a GraphStore "
                f"checkpoint (missing meta: "
                f"{missing or ['stream_store']}) - it was saved by a "
                "different layer or an incompatible version; pick another "
                "step= or re-checkpoint")
        V = int(meta["n_vertices"])
        weighted = bool(meta["weighted"])

        def view_like(n_buckets: int) -> SlabGraph:
            dtypes = {f: torch.int32 for f in FIELDS}
            dtypes.update(weights=torch.float32 if weighted else None,
                          upd_flag=torch.bool, slab_new=torch.bool)
            return SlabGraph(**dtypes, n_vertices=V,
                             n_buckets=int(n_buckets), weighted=weighted)

        like_views = {name: view_like(nb)
                      for name, nb in meta["views"].items()}
        spec_by_name = {s.name: s for s in specs}
        like_props = {}
        for name in meta["prop_versions"]:
            spec = spec_by_name.get(name)
            if spec is None or spec.state_like is None:
                raise KeyError(
                    f"checkpoint stores property {name!r}; pass its "
                    f"PropertySpec (with a state_like) via specs= to "
                    f"restore it")
            like_props[name] = spec.state_like(V)
        tree, _ = ckpt.restore(ckpt_dir, {"views": like_views,
                                          "props": like_props},
                               step=manifest["step"], device=dev)
        store = cls(tree["views"], weighted=weighted,
                    version=meta["version"], log_capacity=log_capacity,
                    maintenance=maintenance)
        store._adopt_resilience_meta(meta)

        registry = None
        if spec_by_name:
            from .properties import PropertyRegistry
            registry = PropertyRegistry(store)
            policies = policies or {}
            for name, spec in spec_by_name.items():
                if name in tree["props"]:
                    registry.register(spec,
                                      policy=policies.get(name, "lazy"),
                                      _state=tree["props"][name],
                                      _version=meta["prop_versions"][name])
                else:
                    registry.register(spec, policy=policies.get(name, "lazy"))
        return store, registry
