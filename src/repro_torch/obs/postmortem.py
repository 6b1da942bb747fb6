"""Crash post-mortems: dump the black box when the serving path dies.

When an apply crashes (an injected kill, an unhandled dispatch failure, a
failed invariant), the process that knows *why* is about to disappear.
This module writes a **post-mortem bundle** — one JSON file beside the
WAL — at the moment of death, carrying everything the next process (or
the operator) needs to reconstruct the incident:

* the failure itself (exception type/message, fault site + hit count for
  injected faults, the armed fault plan's firing record),
* the last-N flight-recorder events (``obs.flight`` — recorded even when
  tracing was off, which is the whole point),
* a metrics snapshot (counters/gauges/histogram summaries, if armed),
* ``pool_stats`` for every store view + the store's resilience meta
  (the maintenance counters recovery must re-derive),
* breaker/guard state for every registered CircuitBreaker.

``resilience.recover`` reads the newest bundle back
(:func:`consume_latest`) so recovery can say why it is recovering — the
``RecoveryReport`` surfaces it and the bundle is archived (renamed
``*.read``) so one incident is reported once.

Placement: bundles land in ``<wal_dir>/postmortem/`` when the store has a
WAL attached (beside the journal, where a recovering process already
looks), else in the module-configured fallback dir, else nowhere (a
store with no durability attached has no recovery protocol to inform).

Dumping must never make a bad situation worse: every step is
best-effort — a failing stats read degrades that section to an error
string, and :func:`dump` never raises.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import flight, metrics

SCHEMA = "repro.postmortem/v1"

#: flight events folded into a bundle
LAST_N_FLIGHT = 256

_FALLBACK_DIR: Optional[Path] = None
_BREAKERS: List[Any] = []           # registered CircuitBreakers (status())

_FL_DUMP = flight.intern("postmortem.dump")
_FL_READ = flight.intern("postmortem.consumed")


def set_bundle_dir(path) -> None:
    """Fallback bundle directory for stores without a WAL (None disables)."""
    global _FALLBACK_DIR
    _FALLBACK_DIR = None if path is None else Path(path)


def register_breaker(breaker) -> None:
    """Track a CircuitBreaker so bundles carry its state (pipeline hook)."""
    if breaker is not None and breaker not in _BREAKERS:
        _BREAKERS.append(breaker)


def reset() -> None:
    """Test teardown: drop the fallback dir and registered breakers."""
    global _FALLBACK_DIR
    _FALLBACK_DIR = None
    _BREAKERS.clear()


def bundle_dir_for(store) -> Optional[Path]:
    wal = getattr(store, "wal", None)
    wal_dir = getattr(wal, "wal_dir", None)
    if wal_dir is not None:
        return Path(wal_dir) / "postmortem"
    return _FALLBACK_DIR


def _describe_exception(exc: Optional[BaseException]) -> Dict[str, Any]:
    if exc is None:
        return {}
    d: Dict[str, Any] = {"type": type(exc).__name__, "message": str(exc)}
    # injected faults carry their site + hit count — the smoke test's
    # "bundle names the fault site" contract reads these
    for attr in ("site", "hit"):
        v = getattr(exc, attr, None)
        if v is not None:
            d[attr] = v
    return d


def store_section(store) -> Dict[str, Any]:
    if store is None:
        return {}
    sec: Dict[str, Any] = {"kind": type(store).__name__}
    for attr in ("version", "n_edges", "n_vertices", "weighted", "n_shards",
                 "maintenance_count"):
        try:
            v = getattr(store, attr, None)
            if v is not None:
                sec[attr] = v if isinstance(v, (bool, str)) else int(v)
        except Exception as e:                      # pragma: no cover
            sec[attr] = f"<unavailable: {e}>"
    try:
        sec["resilience_meta"] = store._resilience_meta()
    except Exception as e:
        sec["resilience_meta"] = f"<unavailable: {e}>"
    pools: Dict[str, Any] = {}
    try:
        for name in store.views:
            try:
                st = store.pool_stats(name)
                pools[name] = {k: (float(v) if isinstance(v, float) else
                                   int(v)) for k, v in st.items()
                               if isinstance(v, (int, float))}
            except Exception as e:
                pools[name] = f"<unavailable: {e}>"
    except Exception as e:
        pools = {"<views>": f"<unavailable: {e}>"}
    sec["pool_stats"] = pools
    return sec


def _fault_section() -> Dict[str, Any]:
    try:
        from ..resilience import faults as _faults
        plan = _faults.active()
        if plan is None:
            return {"armed": False}
        return {"armed": True, "seed": plan.seed,
                "hits": dict(plan.hits), "fired": list(plan.fired)}
    except Exception as e:                          # pragma: no cover
        return {"error": str(e)}


def dump(store=None, *, reason: str, exc: Optional[BaseException] = None,
         bundle_dir=None, extra: Optional[dict] = None) -> Optional[Path]:
    """Write one post-mortem bundle; returns its path (None when no
    directory is resolvable or the write failed — dumping never raises)."""
    try:
        out_dir = Path(bundle_dir) if bundle_dir is not None \
            else bundle_dir_for(store)
        if out_dir is None:
            return None
        out_dir.mkdir(parents=True, exist_ok=True)
        bundle: Dict[str, Any] = {
            "schema": SCHEMA,
            "written_unix": time.time(),
            "pid": os.getpid(),
            "reason": reason,
            "exception": _describe_exception(exc),
            "store": store_section(store),
            "breakers": [],
            "fault_plan": _fault_section(),
            "flight": {"stats": flight.stats(),
                       "events": flight.snapshot(last=LAST_N_FLIGHT)},
        }
        for b in _BREAKERS:
            try:
                bundle["breakers"].append(b.status())
            except Exception as e:                  # pragma: no cover
                bundle["breakers"].append({"error": str(e)})
        try:
            if metrics.enabled():
                s = metrics.get_registry().summary()
                # events can carry non-JSON values; default=str below
                bundle["metrics"] = s
            else:
                bundle["metrics"] = {"armed": False}
        except Exception as e:                      # pragma: no cover
            bundle["metrics"] = {"error": str(e)}
        if extra:
            bundle["extra"] = extra
        version = bundle["store"].get("version", 0) if store else 0
        name = f"postmortem-{time.time_ns()}-v{int(version)}.json"
        tmp = out_dir / (name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=2, default=str)
            f.flush()
            os.fsync(f.fileno())
        path = out_dir / name
        os.replace(tmp, path)
        flight.record(_FL_DUMP, int(version))
        return path
    except Exception:
        return None


def on_apply_failure(store, exc: BaseException) -> Optional[Path]:
    """Store-side hook: dump on crashes and unhandled apply failures, NOT
    on the pipeline-recoverable classes (quarantine / retry exhaustion /
    transient OOM) — those degrade gracefully and recovery never sees
    them."""
    try:
        from ..resilience.faults import InjectedCrash
        from ..resilience.guard import PIPELINE_RECOVERABLE
        if isinstance(exc, PIPELINE_RECOVERABLE):
            return None
        reason = ("injected_crash" if isinstance(exc, InjectedCrash)
                  else "apply_failure")
    except Exception:                               # pragma: no cover
        reason = "apply_failure"
    return dump(store, reason=reason, exc=exc)


def reads_store(store, exc: BaseException) -> bool:
    """Whether ``on_apply_failure(store, exc)`` reads the store's section:
    a failure it dumps, with a bundle directory to dump into.  The ranks
    of a mesh store that write no bundle read it too when this holds
    (the statistics are gathered over the ranks)."""
    from ..resilience.guard import PIPELINE_RECOVERABLE
    return (not isinstance(exc, PIPELINE_RECOVERABLE)
            and bundle_dir_for(store) is not None)


def _bundles(bundle_dir) -> List[Path]:
    d = Path(bundle_dir)
    if not d.is_dir():
        return []
    return sorted(d.glob("postmortem-*.json"))


def latest(bundle_dir) -> Optional[Dict[str, Any]]:
    """Parse the newest bundle in ``bundle_dir`` (None if none parse)."""
    for path in reversed(_bundles(bundle_dir)):
        try:
            doc = json.loads(path.read_text())
            if doc.get("schema") == SCHEMA:
                doc["_path"] = str(path)
                return doc
        except (json.JSONDecodeError, OSError):
            continue
    return None


def consume_latest(bundle_dir) -> Optional[Dict[str, Any]]:
    """``latest`` + archive: the returned bundle is renamed ``*.read`` so
    the incident is reported by exactly one recovery."""
    doc = latest(bundle_dir)
    if doc is None:
        return None
    try:
        path = Path(doc["_path"])
        os.replace(path, path.with_suffix(".json.read"))
        flight.record(_FL_READ)
    except OSError:                                 # pragma: no cover
        pass
    return doc


__all__ = ["SCHEMA", "LAST_N_FLIGHT", "set_bundle_dir", "register_breaker",
           "reset", "bundle_dir_for", "store_section", "dump",
           "on_apply_failure", "reads_store", "latest", "consume_latest"]
