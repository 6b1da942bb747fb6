"""Deterministic fault injection: the chaos half of the resilience plane.

The stores, pipeline, and checkpoint layer carry named *fault points*
(``faults.fault_point("apply.post_wal")`` and friends) at every phase a
production failure can land: after the WAL append, before the epoch close,
mid checkpoint save, inside a capacity grow.  With no plan armed a fault
point is ONE branch on a module flag, the same zero-overhead-when-off
contract as ``obs`` (pools stay bit-identical with the harness
installed).

Arming a plan is a context manager::

    with faults.inject(FaultSpec("apply.post_wal", kind=faults.CRASH,
                                 at=3)) as plan:
        ...               # 3rd apply dies mid-epoch with InjectedCrash
    plan.fired            # structured record of every injected fault

Firing is seedable and fully deterministic: specs select hits by exact
count (``at=``), stride (``every=``), or seeded probability (``p=``), and a
plan replays identically for a given (specs, seed) pair — crash-recovery
tests depend on that to kill the same epoch twice.

Kinds:

* ``CRASH``    — raise :class:`InjectedCrash` (a simulated process kill;
  nothing downstream may catch it — recovery goes through
  ``resilience.recover``),
* ``OOM``      — raise :class:`InjectedOOM` (recoverable; the stores'
  capacity-grow retry budgets absorb a bounded number of these),
* ``LATENCY``  — ``time.sleep(delay_s)`` (latency spikes for SLO tests),
* ``OVERFLOW`` — report ``amount`` synthetic overflow lanes from
  ``fault_overflow`` sites (routing-overflow storms).

Batch *corruption* is not an in-store hook — corrupt batches enter through
the front door (``corrupt_batch`` produces them; the admission guard in
``resilience.guard`` is what must catch them).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..obs import flight as _flight

_FL_FIRED = _flight.intern("fault.fired")

CRASH = "crash"
OOM = "oom"
LATENCY = "latency"
OVERFLOW = "overflow"
_KINDS = (CRASH, OOM, LATENCY, OVERFLOW)


class FaultError(Exception):
    """Base of every injected failure."""


class InjectedCrash(FaultError):
    """A simulated process kill.  Nothing in the serving path may catch
    this — the test/bench harness lets it unwind and then exercises
    ``resilience.recover`` exactly as a restarted process would."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected crash at {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class InjectedOOM(FaultError):
    """A simulated allocation failure (recoverable: retry budgets apply)."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected OOM at {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: where, what, and on which hits it fires.

    Selectors compose as OR: fire when the site's hit count equals ``at``,
    when it is a multiple of ``every``, or with probability ``p`` per hit
    (plan-seeded — deterministic).  ``times`` bounds total firings
    (0 = unlimited).
    """
    site: str
    kind: str = CRASH
    at: int = 0           # fire on exactly the at-th hit (1-based)
    every: int = 0        # fire on every every-th hit
    p: float = 0.0        # per-hit probability (seeded rng)
    times: int = 1        # max firings; 0 = unlimited
    delay_s: float = 0.0  # LATENCY: sleep duration
    amount: int = 0       # OVERFLOW: synthetic overflow lanes reported

    def __post_init__(self):
        assert self.kind in _KINDS, self.kind


class FaultPlan:
    """The armed script: per-site hit counters + the firing record."""

    def __init__(self, specs, seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._remaining = [s.times if s.times else -1 for s in self.specs]
        self.hits: Dict[str, int] = {}
        #: structured record of every injected fault, in firing order
        self.fired: List[dict] = []

    def _matches(self, spec: FaultSpec, count: int) -> bool:
        if spec.at and count == spec.at:
            return True
        if spec.every and count % spec.every == 0:
            return True
        if spec.p and self._rng.random() < spec.p:
            return True
        return False

    def hit(self, site: str, **ctx) -> int:
        """Count one pass through ``site``; act on every armed match.

        Returns the summed OVERFLOW amount (0 normally); raises for CRASH
        and OOM kinds; sleeps for LATENCY.
        """
        count = self.hits.get(site, 0) + 1
        self.hits[site] = count
        overflow = 0
        for idx, spec in enumerate(self.specs):
            if spec.site != site or self._remaining[idx] == 0:
                continue
            if not self._matches(spec, count):
                continue
            if self._remaining[idx] > 0:
                self._remaining[idx] -= 1
            self.fired.append({"site": site, "kind": spec.kind,
                               "hit": count, **ctx})
            obs.emit_event("fault_injected", site=site, kind=spec.kind,
                           hit=count)
            obs.inc(f"faults.{spec.kind}")
            # the black box sees the injection itself (the site string is
            # interned per-fire: faults are rare by construction)
            _flight.record(_FL_FIRED, _flight.intern(f"site.{site}"), count)
            if spec.kind == CRASH:
                raise InjectedCrash(site, count)
            if spec.kind == OOM:
                raise InjectedOOM(site, count)
            if spec.kind == LATENCY:
                time.sleep(spec.delay_s)
            elif spec.kind == OVERFLOW:
                overflow += spec.amount
        return overflow


# --------------------------------------------------------------------------
# the module switch (obs idiom: one branch when disarmed)
# --------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def enabled() -> bool:
    return _PLAN is not None


def active() -> Optional[FaultPlan]:
    return _PLAN


def fault_point(site: str, **ctx) -> None:
    """A named failure site.  No-op (one branch) unless a plan is armed."""
    if _PLAN is None:
        return
    _PLAN.hit(site, **ctx)


def fault_overflow(site: str, **ctx) -> int:
    """Like ``fault_point`` but returns scripted synthetic overflow lanes
    (routing-overflow storms); 0 when disarmed or no OVERFLOW spec fires."""
    if _PLAN is None:
        return 0
    return _PLAN.hit(site, **ctx)


class inject:
    """``with faults.inject(*specs, seed=0) as plan:`` — arm a plan for the
    block.  Nesting is an error (one chaos script at a time); the plan is
    disarmed on exit even when an injected crash unwinds through."""

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self.plan = FaultPlan(specs, seed=seed)

    def __enter__(self) -> FaultPlan:
        global _PLAN
        if _PLAN is not None:
            raise RuntimeError("a fault plan is already armed")
        _PLAN = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _PLAN
        _PLAN = None
        return False


def reset() -> None:
    """Disarm whatever plan is installed (test teardown hook)."""
    global _PLAN
    _PLAN = None


# --------------------------------------------------------------------------
# scripted batch corruption (consumed by tests and the chaos bench)
# --------------------------------------------------------------------------

NAN_WEIGHT = "nan_weight"
SENTINEL_DST = "sentinel_dst"
OOB_SRC = "oob_src"
NEGATIVE_SRC = "negative_src"
CORRUPTION_MODES = (NAN_WEIGHT, SENTINEL_DST, OOB_SRC, NEGATIVE_SRC)


def corrupt_batch(rng: np.random.Generator, ins_src, ins_dst, ins_w=None, *,
                  mode: str, n_vertices: int = 0, lanes: int = 1):
    """Deterministically corrupt ``lanes`` positions of an insert batch.

    Returns ``(src, dst, w)`` copies — the inputs are never mutated.  The
    corrupted batch is meant to be fed through the FRONT of the pipeline;
    the admission guard (``guard.validate_batch``) must quarantine it
    before any store state moves.
    """
    assert mode in CORRUPTION_MODES, mode
    src = np.array(ins_src, copy=True)
    dst = np.array(ins_dst, copy=True)
    w = None if ins_w is None else np.array(ins_w, np.float32, copy=True)
    if len(src) == 0:
        return src, dst, w
    pos = rng.choice(len(src), size=min(lanes, len(src)), replace=False)
    if mode == NAN_WEIGHT:
        if w is None:
            w = np.ones(len(src), np.float32)
        w[pos] = np.nan
    elif mode == SENTINEL_DST:
        from ..core.hashing import EMPTY_KEY
        dst = dst.astype(np.int64)
        dst[pos] = EMPTY_KEY & 0xFFFFFFFF       # the uint32 sentinel
    elif mode == OOB_SRC:
        src = src.astype(np.int64)
        src[pos] = int(n_vertices) + 7
    elif mode == NEGATIVE_SRC:
        src = src.astype(np.int64)
        src[pos] = -3
    return src, dst, w
