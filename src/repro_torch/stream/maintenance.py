"""Maintenance policy: when and how a store compacts its pools.

The update plane only appends (deletes leave tombstones, ``next_free`` only
advances), so something must decide when the dead lanes are worth a
re-pack.  ``MaintenancePolicy`` is a small set of triggers evaluated on the
forward view at every epoch close.  Two tiers exist:

* ``"compact"`` - the full re-pack (``kernels/slab_compact``): every view
  rebuilt dense as one versioned unit, capacity allowed back down the
  power-of-two ladder.  Slab handles kept across a compaction are stale;
  each view's ``CompactionReport.perm`` says where an old slab's content
  went.  Vertex ids do not change, so vertex-keyed property states
  survive, and the registry skips maintenance batches when it replays.
* ``"reclaim"`` - wholly dead overflow slabs are unlinked and pushed onto
  the free list, which insert placement drains before ``next_free``.  No
  lane moves and no handle goes stale.

Triggers (0 or 0.0 disables one):

* ``tombstone_ratio``    - dead lanes / occupied lanes >= threshold:
  compact.  The primary churn signal.
* ``max_mean_chain``     - mean slabs per bucket >= threshold: compact.
* ``min_occupancy``      - live lanes / allocated lanes < threshold:
  compact.  Off by default: buckets never merge, so a sparse graph of
  one-slab chains has a low occupancy that no compaction raises.
* ``reclaim_dead_slabs`` - at least N wholly dead slabs: reclaim (when no
  trigger above fired).
* ``every``              - compact every N epochs.

``shrink_occupancy`` gates the capacity drop: a compacted pool steps down
the ladder only when at most that fraction of its rows is allocated (1.0
always allows it, 0.0 never).  The store also keeps the last insert epoch's
slab reservation as slack, so a shrunk pool does not have to grow right
back for the next batch of the same size.

Unlike the reference's policy this one names no compaction ``impl``: a
store compacts with the kernels on the card and with their plain versions
on the CPU, never through the sort-based oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..kernels.slab_compact import CompactionReport

COMPACT = "compact"
RECLAIM = "reclaim"


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    tombstone_ratio: float = 0.25
    max_mean_chain: float = 0.0
    min_occupancy: float = 0.0
    reclaim_dead_slabs: int = 0
    every: int = 0
    shrink_occupancy: float = 1.0
    slack_slabs: int = 64

    def decide(self, stats: dict, *, epochs_since: int
               ) -> Optional[Tuple[str, str]]:
        """``(action, trigger)`` or None, from the forward view's stats."""
        if self.every and epochs_since >= self.every:
            return COMPACT, f"every={self.every} epochs"
        if self.tombstone_ratio and \
                stats["tombstone_ratio"] >= self.tombstone_ratio:
            return COMPACT, (f"tombstone_ratio {stats['tombstone_ratio']:.3f}"
                             f" >= {self.tombstone_ratio}")
        if self.max_mean_chain and \
                stats["mean_chain"] >= self.max_mean_chain:
            return COMPACT, (f"mean_chain {stats['mean_chain']:.2f}"
                             f" >= {self.max_mean_chain}")
        if self.min_occupancy and stats["occupancy"] < self.min_occupancy:
            return COMPACT, (f"occupancy {stats['occupancy']:.3f}"
                             f" < {self.min_occupancy}")
        if self.reclaim_dead_slabs and \
                stats["dead_slabs"] >= self.reclaim_dead_slabs:
            return RECLAIM, (f"dead_slabs {stats['dead_slabs']}"
                             f" >= {self.reclaim_dead_slabs}")
        return None

    def allow_shrink(self, stats: dict) -> bool:
        """Capacity may step down only when the pool is empty enough."""
        frac = stats["allocated_slabs"] / max(1, stats["capacity_slabs"])
        return frac <= self.shrink_occupancy


@dataclasses.dataclass(frozen=True)
class MaintenanceRecord:
    """One maintenance pass over every view (one versioned unit)."""
    version: int                           # store version after the pass
    action: str                            # "compact" | "reclaim"
    trigger: str                           # the clause that fired
    reports: Dict[str, CompactionReport]   # per view (compact only)
    reclaimed: Dict[str, int]              # per view (reclaim only)
    duration_s: float
    #: seconds of the forward-view ``pool_stats`` scans this pass ran (the
    #: trigger's and the shrink test's), outside ``duration_s``
    scan_s: float = 0.0
    tombstone_ratio: float = 0.0           # before the pass
    capacity_before: int = 0               # forward view, slabs
    capacity_after: int = 0
    slabs_reclaimed: int = 0               # over every view (reclaim)

    def as_event(self) -> dict:
        """The pass as one flat event."""
        return {
            "version": self.version, "action": self.action,
            "trigger": self.trigger,
            "tombstone_ratio": self.tombstone_ratio,
            "capacity_before": self.capacity_before,
            "capacity_after": self.capacity_after,
            "slabs_reclaimed": self.slabs_reclaimed,
            "duration_s": self.duration_s,
        }

    def describe(self) -> str:
        if self.action == COMPACT:
            caps = {name: f"{r.old_capacity}->{r.new_capacity}"
                    for name, r in self.reports.items()}
            return f"compact v{self.version} [{self.trigger}] {caps}"
        total = sum(self.reclaimed.values())
        return f"reclaim v{self.version} [{self.trigger}] {total} slabs"


__all__ = ["COMPACT", "RECLAIM", "MaintenancePolicy", "MaintenanceRecord"]
