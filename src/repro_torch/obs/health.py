"""SLO burn-rate health engine.

Counters say what happened; SLOs say whether it was acceptable.  This
module keeps windowed rings of the signals that predict a serving
incident (per-class request latency, pool tombstone ratio and occupancy,
per-shard route imbalance, property staleness) and turns them into
error-budget burn rates against declared targets:

    budget     = 1 - objective              (the tolerated violation rate)
    burn_rate  = violation_rate / budget    (over the sliding window)

``burn_rate == 1`` spends the budget exactly as fast as the SLO allows;
``burn_rate > 1`` is an incident in progress.  A target with
``objective=0.99`` tolerates 1% violations, so a window where 5% of the
update requests miss their latency target burns at 5x.

:class:`HealthReport` is the output record.  ``launch/serve.py --health``
prints it, and ``resilience.guard.CircuitBreaker.note_health`` sheds update
load when the worst burn rate reaches the breaker's ``burn_threshold``,
reacting to latency violations that never raise.

Everything here is host arithmetic on small preallocated numpy rings;
sampling a store reads its ``_cheap_stats`` (exact tombstone accounting,
no device sync), so the engine runs inside the serving loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import flight, metrics

_FL_REPORT = flight.intern("health.report")
_FL_BURN = flight.intern("health.burn_alert")


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One declared objective: ``objective`` of class-``request_class``
    requests must complete within ``latency_s`` (errors always violate)."""
    request_class: str
    latency_s: float
    objective: float = 0.99

    def __post_init__(self):
        assert 0.0 < self.objective < 1.0, self.objective
        assert self.latency_s > 0.0, self.latency_s

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


class _Ring:
    """Fixed-capacity float ring with a parallel violation-flag lane."""
    __slots__ = ("values", "flags", "head", "total")

    def __init__(self, capacity: int):
        self.values = np.zeros(int(capacity), np.float64)
        self.flags = np.zeros(int(capacity), bool)
        self.head = 0
        self.total = 0

    def push(self, value: float, flag: bool = False) -> None:
        i = self.head
        self.values[i] = value
        self.flags[i] = flag
        self.head = (i + 1) % len(self.values)
        self.total += 1

    @property
    def n(self) -> int:
        return min(self.total, len(self.values))

    def window(self) -> Tuple[np.ndarray, np.ndarray]:
        n = self.n
        if self.total <= len(self.values):
            return self.values[:n], self.flags[:n]
        idx = (np.arange(self.head, self.head + len(self.values))
               % len(self.values))
        return self.values[idx], self.flags[idx]


@dataclasses.dataclass(frozen=True)
class ClassHealth:
    request_class: str
    samples: int
    violations: int
    violation_rate: float
    objective: Optional[float]
    budget: Optional[float]
    burn_rate: Optional[float]        # None without a declared target
    p50_s: float
    max_s: float


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One windowed health evaluation (all rates over the ring windows)."""
    classes: Tuple[ClassHealth, ...]
    worst_burn: float                 # max burn over targeted classes (0 ok)
    worst_burn_class: Optional[str]
    pool: Dict[str, float]            # tombstone ratio / occupancy trends
    shard_imbalance: Dict[str, float]
    staleness: Dict[str, int]
    healthy: bool

    def as_dict(self) -> Dict[str, Any]:
        return {
            "classes": [dataclasses.asdict(c) for c in self.classes],
            "worst_burn": self.worst_burn,
            "worst_burn_class": self.worst_burn_class,
            "pool": dict(self.pool),
            "shard_imbalance": dict(self.shard_imbalance),
            "staleness": dict(self.staleness),
            "healthy": self.healthy,
        }

    def render(self) -> str:
        lines = [f"health: {'OK' if self.healthy else 'BURNING'} "
                 f"(worst burn {self.worst_burn:.2f}"
                 + (f" on {self.worst_burn_class}" if self.worst_burn_class
                    else "") + ")"]
        for c in self.classes:
            burn = ("-" if c.burn_rate is None else f"{c.burn_rate:6.2f}")
            lines.append(
                f"  {c.request_class:10s} n={c.samples:<5d} "
                f"viol={c.violations:<4d} rate={c.violation_rate:6.3f} "
                f"burn={burn} p50={1e3 * c.p50_s:8.1f}ms "
                f"max={1e3 * c.max_s:8.1f}ms")
        if self.pool:
            lines.append("  pool: " + " ".join(
                f"{k}={v:.3f}" for k, v in sorted(self.pool.items())))
        if self.shard_imbalance:
            lines.append("  shards: " + " ".join(
                f"{k}={v:.2f}" for k, v in sorted(
                    self.shard_imbalance.items())))
        if self.staleness:
            lines.append("  staleness: " + " ".join(
                f"{k}={v}" for k, v in sorted(self.staleness.items())))
        return "\n".join(lines)


class HealthEngine:
    """Windowed signal collector + burn-rate evaluator (module doc)."""

    def __init__(self, targets: Sequence[SLOTarget] = (), *,
                 window: int = 256, store_window: int = 64):
        self.targets: Dict[str, SLOTarget] = \
            {t.request_class: t for t in targets}
        self.window = int(window)
        self._lat: Dict[str, _Ring] = {}
        self._tomb = _Ring(store_window)
        self._occ = _Ring(store_window)
        self._staleness: Dict[str, int] = {}
        self.reports = 0

    # -- feeds --------------------------------------------------------------
    def observe_request(self, request_class: str, latency_s: float,
                        ok: bool = True) -> None:
        """One served request: the violation flag is (error OR latency past
        the class target); classes without a target track latency only."""
        ring = self._lat.get(request_class)
        if ring is None:
            ring = self._lat[request_class] = _Ring(self.window)
        target = self.targets.get(request_class)
        violated = (not ok) or (target is not None
                                and latency_s > target.latency_s)
        ring.push(float(latency_s), violated)

    def observe_store(self, store) -> None:
        """O(1) pool sample (exact tombstone accounting, no device sync)."""
        try:
            st = store._cheap_stats()
        except Exception:
            return
        self._tomb.push(float(st.get("tombstone_ratio", 0.0)))
        self._occ.push(float(st.get("occupancy", 1.0)))

    def observe_staleness(self, registry) -> Dict[str, int]:
        """Per-property epochs-behind snapshot (returned AND folded into
        the next report)."""
        out: Dict[str, int] = {}
        try:
            status = registry.status()
            version = registry.store.version
            for name, s in status.items():
                out[name] = int(version) - int(s.get("version", version))
        except Exception:
            return out
        self._staleness = out
        return out

    # -- evaluation ---------------------------------------------------------
    def _class_health(self, cls: str, ring: _Ring) -> ClassHealth:
        vals, flags = ring.window()
        n = len(vals)
        viol = int(flags.sum())
        rate = viol / n if n else 0.0
        target = self.targets.get(cls)
        burn = budget = objective = None
        if target is not None:
            objective, budget = target.objective, target.budget
            burn = rate / budget if n else 0.0
        return ClassHealth(
            request_class=cls, samples=n, violations=viol,
            violation_rate=rate, objective=objective, budget=budget,
            burn_rate=burn,
            p50_s=float(np.median(vals)) if n else 0.0,
            max_s=float(vals.max()) if n else 0.0)

    def _shard_imbalance(self) -> Dict[str, float]:
        """Route-imbalance gauges mirrored from the metrics plane (the
        sharded store publishes ``store.route.{ins,del}.imbalance`` when
        metrics are armed)."""
        out: Dict[str, float] = {}
        if not metrics.enabled():
            return out
        gauges = metrics.get_registry().summary()["gauges"]
        for k, v in gauges.items():
            if k.startswith("store.route.") and k.endswith(".imbalance"):
                out[k.split(".")[2]] = float(v)
        return out

    def report(self) -> HealthReport:
        classes = tuple(self._class_health(c, r)
                        for c, r in sorted(self._lat.items()))
        targeted = [c for c in classes if c.burn_rate is not None]
        worst = max(targeted, key=lambda c: c.burn_rate, default=None)
        worst_burn = worst.burn_rate if worst else 0.0
        pool: Dict[str, float] = {}
        tv, _ = self._tomb.window()
        ov, _ = self._occ.window()
        if len(tv):
            pool["tombstone_ratio"] = float(tv[-1])
            pool["tombstone_trend"] = float(tv[-1] - tv[0])
        if len(ov):
            pool["occupancy"] = float(ov[-1])
        report = HealthReport(
            classes=classes, worst_burn=worst_burn,
            worst_burn_class=worst.request_class if worst else None,
            pool=pool, shard_imbalance=self._shard_imbalance(),
            staleness=dict(self._staleness),
            healthy=worst_burn < 1.0)
        self.reports += 1
        flight.record(_FL_REPORT, int(1e3 * worst_burn),
                      sum(c.samples for c in classes))
        if not report.healthy:
            flight.record(_FL_BURN, int(1e3 * worst_burn))
            metrics.emit_event("health_burning", worst_burn=worst_burn,
                               request_class=report.worst_burn_class)
        if metrics.enabled():
            metrics.set_gauge("health.worst_burn", worst_burn)
        return report


__all__ = ["SLOTarget", "HealthEngine", "HealthReport", "ClassHealth"]
