"""Admission guards and overload protection for the serving path.

Three defenses, all host-side and state-free until they fire:

* :func:`validate_batch` - admission validation of RAW update inputs, run
  before ``canonical_batch``'s uint32 casts could wrap a negative id or
  truncate a float.  A bad batch raises :class:`QuarantinedBatch` with
  structured per-field reasons; the store has not moved.  ``src`` ids
  index bucket layouts and must be ``< n_vertices``; ``dst`` ids may
  exceed ``n_vertices`` but must not collide with the reserved key
  sentinels.
* :class:`RetryBudget` / :func:`run_with_retries` - bounded retries
  around capacity growth.  Only :class:`InjectedOOM` is retried, as in the
  reference; exhaustion raises :class:`RetryExhausted`.
* :class:`CircuitBreaker` - trips after ``threshold`` consecutive apply
  failures, or (with ``burn_threshold``) when an ``obs.health`` report's
  worst burn rate reaches the threshold; while open the pipeline sheds
  update groups and serves version-tagged stale property reads.  The
  cooldown counts shed groups, not wall time, so runs replay
  deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np

from .. import obs
from ..core.hashing import EMPTY_KEY, INVALID_VERTEX, TOMBSTONE_KEY
from ..obs import flight as _flight
from .faults import InjectedOOM

_FL_TRIP = _flight.intern("breaker.open")
_FL_CLOSE = _flight.intern("breaker.closed")
_FL_HALF = _flight.intern("breaker.half_open")
_FL_SHED = _flight.intern("breaker.shed")
_FL_BURN_TRIP = _flight.intern("breaker.burn_trip")

#: dst ids the update plane reserves: TOMBSTONE_KEY, EMPTY_KEY and
#: INVALID_VERTEX read as the uint32 ids a host batch carries
_SENTINELS = tuple(int(k) & 0xFFFFFFFF
                   for k in (TOMBSTONE_KEY, EMPTY_KEY, INVALID_VERTEX))


class QuarantinedBatch(Exception):
    """An update batch rejected at admission.  ``reasons`` is a list of
    ``{"field", "reason", "count", "example"}`` dicts."""

    def __init__(self, reasons: List[dict]):
        self.reasons = reasons
        bits = "; ".join(f"{r['field']}: {r['reason']} x{r['count']}"
                         for r in reasons)
        super().__init__(f"batch quarantined - {bits}")


class RetryExhausted(Exception):
    """A bounded retry loop ran out of budget."""

    def __init__(self, site: str, attempts: int, last: Exception):
        super().__init__(f"{site}: {attempts} attempts exhausted "
                         f"(last: {last})")
        self.site = site
        self.attempts = attempts
        self.last = last


def _check_ids(reasons: List[dict], field: str, raw, *, n_vertices: int,
               is_src: bool) -> None:
    a = np.asarray(() if raw is None else raw)
    if a.size == 0:
        return
    if a.dtype.kind == "f":
        bad = ~np.isfinite(a)
        if bad.any():
            reasons.append({"field": field, "reason": "non-finite id",
                            "count": int(bad.sum()),
                            "example": float(a[bad][0])})
            return
    elif a.dtype.kind not in "iub":
        reasons.append({"field": field, "reason": "non-numeric dtype",
                        "count": int(a.size), "example": str(a.dtype)})
        return
    a = a.astype(np.int64)
    neg = a < 0
    if neg.any():
        reasons.append({"field": field, "reason": "negative id",
                        "count": int(neg.sum()), "example": int(a[neg][0])})
        return
    if is_src:
        bad = a >= n_vertices
        reason = f"src >= n_vertices ({n_vertices})"
    else:
        bad = (a > 0xFFFFFFFF) | np.isin(a, _SENTINELS)
        reason = "reserved/overflowing dst key"
    if bad.any():
        reasons.append({"field": field, "reason": reason,
                        "count": int(bad.sum()), "example": int(a[bad][0])})


def validate_batch(ins_src, ins_dst, ins_w, del_src, del_dst, *,
                   n_vertices: int) -> None:
    """Raise :class:`QuarantinedBatch` on mismatched halves, non-finite or
    negative ids, src outside the vertex range, dst on a key sentinel, or
    non-finite weights.  An accepted batch passes through untouched."""
    reasons: List[dict] = []
    n_ins = len(np.asarray(() if ins_src is None else ins_src))
    n_ind = len(np.asarray(() if ins_dst is None else ins_dst))
    n_del = len(np.asarray(() if del_src is None else del_src))
    n_dd = len(np.asarray(() if del_dst is None else del_dst))
    if n_ins != n_ind:
        reasons.append({"field": "ins", "reason":
                        f"src/dst length mismatch ({n_ins} vs {n_ind})",
                        "count": 1, "example": None})
    if n_del != n_dd:
        reasons.append({"field": "del", "reason":
                        f"src/dst length mismatch ({n_del} vs {n_dd})",
                        "count": 1, "example": None})
    if ins_w is not None:
        w = np.asarray(ins_w)
        if len(w) != n_ins:
            reasons.append({"field": "ins_w", "reason":
                            f"weight length mismatch ({len(w)} vs {n_ins})",
                            "count": 1, "example": None})
        elif w.size:
            bad = ~np.isfinite(w.astype(np.float64, copy=False))
            if bad.any():
                reasons.append({"field": "ins_w",
                                "reason": "non-finite weight",
                                "count": int(bad.sum()),
                                "example": float(w[bad][0])})
    if not reasons:
        for field, raw, is_src in (("ins_src", ins_src, True),
                                   ("ins_dst", ins_dst, False),
                                   ("del_src", del_src, True),
                                   ("del_dst", del_dst, False)):
            _check_ids(reasons, field, raw, n_vertices=n_vertices,
                       is_src=is_src)
    if reasons:
        obs.emit_event("batch_quarantined", reasons=len(reasons))
        obs.inc("guard.quarantined")
        raise QuarantinedBatch(reasons)


@dataclasses.dataclass(frozen=True)
class RetryBudget:
    """Bounded retry with backoff for transient allocation failures."""
    max_attempts: int = 4
    backoff_s: float = 0.0     # 0 keeps runs free of wall-clock waits
    multiplier: float = 2.0


def run_with_retries(fn: Callable[[], Any], *, budget: RetryBudget,
                     site: str) -> Any:
    """Run ``fn`` under the budget; only :class:`InjectedOOM` is retried.
    Exhaustion raises :class:`RetryExhausted`."""
    delay = budget.backoff_s
    last: Optional[Exception] = None
    for attempt in range(1, budget.max_attempts + 1):
        try:
            return fn()
        except InjectedOOM as e:
            last = e
            obs.emit_event("retry", site=site, attempt=attempt)
            obs.inc(f"guard.retry.{site}")
            if delay:
                time.sleep(delay)
                delay *= budget.multiplier
    raise RetryExhausted(site, budget.max_attempts, last)


#: the failure classes the pipeline turns into error responses (an
#: InjectedCrash is not among them: a simulated kill must unwind)
PIPELINE_RECOVERABLE = (QuarantinedBatch, RetryExhausted, InjectedOOM)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Count-based breaker over the pipeline's update path.

    ``threshold`` consecutive apply failures trip it OPEN; while open every
    update group is shed (``allow()`` False).  After ``cooldown`` shed
    groups it goes HALF_OPEN and admits one probe: success closes it,
    failure re-opens it and restarts the cooldown.

    ``burn_threshold`` (optional) arms SLO burn-rate shedding: fed
    ``obs.health`` reports through :meth:`note_health`, the breaker trips
    OPEN when the worst error-budget burn rate reaches the threshold,
    reacting to latency violations that never raise.  Burn trips go
    through the same OPEN, HALF_OPEN, probe cycle.
    """

    def __init__(self, *, threshold: int = 3, cooldown: int = 8,
                 burn_threshold: Optional[float] = None):
        if threshold < 1 or cooldown < 1:
            raise ValueError("threshold and cooldown must be >= 1")
        if burn_threshold is not None and burn_threshold <= 0.0:
            raise ValueError("burn_threshold must be > 0")
        self.threshold = int(threshold)
        self.cooldown = int(cooldown)
        self.burn_threshold = burn_threshold
        self.state = CLOSED
        self.failures = 0          # consecutive failures while closed
        self.trips = 0
        self.burn_trips = 0        # trips driven by note_health
        self.shed_count = 0        # update groups shed in all
        self._shed_since_trip = 0
        self.last_burn = 0.0

    def allow(self) -> bool:
        """May the next update group run?  Call ``shed`` when it may not."""
        if self.state == OPEN and self._shed_since_trip >= self.cooldown:
            self.state = HALF_OPEN
            obs.emit_event("breaker_half_open")
            _flight.record(_FL_HALF)
        return self.state != OPEN

    def shed(self) -> None:
        self.shed_count += 1
        self._shed_since_trip += 1
        obs.inc("breaker.shed")
        _flight.record(_FL_SHED, self.shed_count)

    def record_success(self) -> None:
        if self.state != CLOSED:
            obs.emit_event("breaker_closed")
            _flight.record(_FL_CLOSE)
        self.state = CLOSED
        self.failures = 0

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == HALF_OPEN or self.failures >= self.threshold:
            self._trip(obs_event="breaker_open")

    def _trip(self, *, obs_event: str) -> None:
        if self.state != OPEN:
            self.trips += 1
            obs.emit_event(obs_event, failures=self.failures)
            obs.inc("breaker.trips")
            _flight.record(_FL_TRIP, self.failures)
        self.state = OPEN
        self._shed_since_trip = 0

    def note_health(self, report) -> bool:
        """Fold one ``obs.health.HealthReport`` in; True when it tripped
        the breaker.  A no-op without ``burn_threshold``.  An OPEN breaker
        stays open (the cooldown cycle re-closes it); a burning window
        while HALF_OPEN re-opens it like a failed probe."""
        if self.burn_threshold is None:
            return False
        self.last_burn = float(report.worst_burn)
        if self.state == OPEN or self.last_burn < self.burn_threshold:
            return False
        self.burn_trips += 1
        _flight.record(_FL_BURN_TRIP, int(1e3 * self.last_burn))
        obs.inc("breaker.burn_trips")
        self._trip(obs_event="breaker_burn_open")
        return True

    def status(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "trips": self.trips, "shed": self.shed_count,
                "burn_trips": self.burn_trips,
                "burn_threshold": self.burn_threshold,
                "last_burn": self.last_burn}
