"""Always-on flight recorder: the black box of the telemetry plane.

``trace``/``metrics`` are forward-looking: you arm them *before* the run
you care about.  Incidents do not schedule themselves, so this module
keeps a fixed-size, preallocated ring buffer of compact encoded events
that the serving path writes into ALWAYS — store apply/maintain phases,
pipeline request classes, breaker transitions, WAL appends, kernel
dispatches, fault firings — even with tracing and metrics off.  When a
crash (or a curious operator) asks, the last ``capacity`` events are
there: ``snapshot()`` decodes them, ``export_chrome_trace()`` renders
them as instant events Perfetto can open, and ``obs.postmortem`` folds
them into every crash bundle.

Design constraints, in order:

* **bit-neutral** — recording only reads ``perf_counter_ns`` and writes
  host-side ints; it can never change a pool value (the port's
  neutrality test holds the store to it);
* **no allocation on the hot path** — the ring arrays (int64 numpy) are
  allocated once at configure time; ``record`` does four scalar stores
  and a masked increment, no locks, no dict lookups (event names are
  interned to integer codes once, at call-site import time);
* **bounded** — the ring wraps; ``stats()`` reports how many events the
  wrap dropped, so a reader knows whether the window is complete.

Event encoding: one record is ``(ts_ns, code, a, b, c)`` — an integer
``perf_counter_ns`` timestamp, the interned event-name code, and three
free int64 payload lanes whose meaning is per-event (store version,
insert count, latency in ns, shard id, ...).  ``intern(name)`` is the
only registration step; the reverse table decodes on export.

Concurrency: ``record`` is intentionally lock-free — a torn record under
thread races costs one garbled diagnostic event, never a wrong pool.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

_lock = threading.Lock()          # guards intern/configure/export, NOT record

_ON = True                        # the black box records by default
_DEFAULT_CAPACITY = 1 << 12

_NAMES: List[str] = []            # code -> name
_CODES: Dict[str, int] = {}       # name -> code

_TS = np.zeros(_DEFAULT_CAPACITY, np.int64)
_CODE = np.zeros(_DEFAULT_CAPACITY, np.int64)
_A = np.zeros(_DEFAULT_CAPACITY, np.int64)
_B = np.zeros(_DEFAULT_CAPACITY, np.int64)
_C = np.zeros(_DEFAULT_CAPACITY, np.int64)
_MASK = _DEFAULT_CAPACITY - 1
_head = 0                         # next write slot
_total = 0                        # lifetime records (>= capacity once wrapped)


def enabled() -> bool:
    return _ON


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    """Strip the recorder (the neutrality A/B arm; production leaves it on)."""
    global _ON
    _ON = False


def capacity() -> int:
    return _MASK + 1


def configure(capacity: int = _DEFAULT_CAPACITY) -> None:
    """(Re)allocate the ring.  Capacity is rounded up to a power of two;
    collected events are dropped (this is a sizing call, not a reset)."""
    global _TS, _CODE, _A, _B, _C, _MASK, _head, _total
    cap = 1
    while cap < max(2, int(capacity)):
        cap <<= 1
    with _lock:
        _TS = np.zeros(cap, np.int64)
        _CODE = np.zeros(cap, np.int64)
        _A = np.zeros(cap, np.int64)
        _B = np.zeros(cap, np.int64)
        _C = np.zeros(cap, np.int64)
        _MASK = cap - 1
        _head = 0
        _total = 0


def reset() -> None:
    """Drop every recorded event (capacity and intern table survive —
    interned codes are compiled into call sites and must stay stable)."""
    global _head, _total
    with _lock:
        _TS[:] = 0
        _CODE[:] = 0
        _head = 0
        _total = 0


def intern(name: str) -> int:
    """Name -> stable integer code (register once, at import time)."""
    with _lock:
        code = _CODES.get(name)
        if code is None:
            code = len(_NAMES)
            _NAMES.append(name)
            _CODES[name] = code
        return code


def name_of(code: int) -> str:
    try:
        return _NAMES[code]
    except IndexError:
        return f"?{code}"


def record(code: int, a: int = 0, b: int = 0, c: int = 0) -> None:
    """The hot path: one ring write.  Lock-free by design (module doc)."""
    global _head, _total
    if not _ON:
        return
    i = _head
    _TS[i] = time.perf_counter_ns()
    _CODE[i] = code
    _A[i] = a
    _B[i] = b
    _C[i] = c
    _head = (i + 1) & _MASK
    _total += 1


_note_codes: Dict[str, int] = {}


def note(name: str, a: int = 0, b: int = 0, c: int = 0) -> None:
    """Convenience recorder for cold call sites (interns on first use;
    hot paths should hold a module-level ``intern()`` code instead)."""
    code = _note_codes.get(name)
    if code is None:
        code = _note_codes[name] = intern(name)
    record(code, a, b, c)


def stats() -> Dict[str, int]:
    cap = _MASK + 1
    return {"capacity": cap, "recorded": _total,
            "in_window": min(_total, cap),
            "dropped": max(0, _total - cap)}


def snapshot(last: Optional[int] = None) -> List[Dict[str, Any]]:
    """Decode the ring, oldest first: ``{"ts_ns", "event", "a", "b", "c"}``
    dicts.  ``last=N`` keeps only the newest N events (the post-mortem
    window)."""
    with _lock:
        cap = _MASK + 1
        n = min(_total, cap)
        head = _head
        if n == 0:
            return []
        if _total <= cap:
            idx = np.arange(0, head)[-n:]
        else:
            idx = (np.arange(head, head + cap) & _MASK)
        ts, code = _TS[idx].copy(), _CODE[idx].copy()
        a, b, c = _A[idx].copy(), _B[idx].copy(), _C[idx].copy()
    out = [{"ts_ns": int(ts[k]), "event": name_of(int(code[k])),
            "a": int(a[k]), "b": int(b[k]), "c": int(c[k])}
           for k in range(len(ts))]
    if last is not None:
        out = out[-int(last):]
    return out


def export_chrome_trace(path) -> str:
    """Write the ring as Chrome trace-event JSON (``i`` instant events,
    ``ts`` in µs relative to the oldest recorded event) — the same schema
    ``trace.export_chrome_trace`` emits, so the black box opens in
    Perfetto too."""
    import os
    events = snapshot()
    t0 = events[0]["ts_ns"] if events else 0
    pid = os.getpid()
    evs = [{"ph": "i", "name": e["event"], "ts": (e["ts_ns"] - t0) / 1e3,
            "pid": pid, "tid": 0, "s": "t",
            "args": {"a": e["a"], "b": e["b"], "c": e["c"]}}
           for e in events]
    payload = {"traceEvents": evs, "displayTimeUnit": "ms",
               "flightStats": stats()}
    path = str(path)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


__all__ = ["enable", "disable", "enabled", "configure", "reset",
           "capacity", "intern", "name_of", "record", "note",
           "snapshot", "stats", "export_chrome_trace"]
