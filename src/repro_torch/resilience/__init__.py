"""The fault-tolerance plane of the serving loop.

* ``faults``     - deterministic, seedable fault injection at named sites
  across the store, the pipeline and the checkpoint layer (one branch per
  site when disarmed; pools bit-identical on and off);
* ``wal``        - a durable CRC-framed write-ahead log of canonical
  batches (fsync before the engine runs, segment rotation, truncation
  once a checkpoint covers a segment) and ``recover()``: restore plus
  WAL-suffix replay, bit-identical to the uninterrupted run;
* ``invariants`` - structural pool audits (chains, degrees, free list,
  cross-view edge multisets) on an ``AuditPolicy(every=N)`` cadence;
* ``guard``      - admission validation (``QuarantinedBatch``), bounded
  capacity-grow retries and the pipeline's circuit breaker.

All of it is opt-in: a store with no WAL, no audit policy and no fault
plan armed takes the plain path.
"""
from __future__ import annotations

from . import faults, guard, invariants, wal
from .faults import (CRASH, LATENCY, OOM, OVERFLOW, FaultError, FaultPlan,
                     FaultSpec, InjectedCrash, InjectedOOM, corrupt_batch,
                     fault_overflow, fault_point, inject)
from .guard import (PIPELINE_RECOVERABLE, CircuitBreaker, QuarantinedBatch,
                    RetryBudget, RetryExhausted, run_with_retries,
                    validate_batch)
from .invariants import (AuditPolicy, InvariantReport,
                         InvariantViolationError, Violation, audit_graph,
                         audit_store, edge_multiset_hash)
from .wal import (RecoveryReport, WalRecord, WriteAheadLog, read_wal,
                  recover)

__all__ = [
    "faults", "guard", "invariants", "wal",
    "CRASH", "OOM", "LATENCY", "OVERFLOW",
    "FaultError", "FaultPlan", "FaultSpec", "InjectedCrash", "InjectedOOM",
    "corrupt_batch", "fault_point", "fault_overflow", "inject",
    "QuarantinedBatch", "RetryBudget", "RetryExhausted", "CircuitBreaker",
    "run_with_retries", "validate_batch", "PIPELINE_RECOVERABLE",
    "AuditPolicy", "InvariantReport", "InvariantViolationError", "Violation",
    "audit_graph", "audit_store", "edge_multiset_hash",
    "WriteAheadLog", "WalRecord", "RecoveryReport", "read_wal", "recover",
]
