"""Span tracing for the telemetry plane.

Nestable wall-clock spans over the serving path — store epochs, request
groups, kernel dispatches — exported as Chrome trace-event JSON (the
``B``/``E`` duration-event schema) viewable in Perfetto or
``chrome://tracing``.  Spans carry structured tags (store version, epoch
phase, shard, pool shape) in the event ``args``.

Zero-overhead-when-off contract: tracing is OFF by default and ``span()``
then returns a shared no-op context manager after one module-flag check —
no allocation, no clock read, no stack touch.  Enabling tracing never
changes computed values: spans only read clocks and (optionally) wait for
already-launched device work so asynchronous launches are attributed to
the span that made them (the *device-sync boundary*, ``sync=``).  Pools
are leaf-for-leaf identical with tracing on and off.

Thread model: one event list guarded by a lock, per-thread nesting depth.
Timestamps are INTEGER ``perf_counter_ns`` nanoseconds relative to the
tracer's epoch end-to-end (``ts_ns`` on every stored event) — no float
accumulates, so a multi-hour serve trace keeps full sub-µs precision.
The Chrome-facing ``ts`` (µs) is derived at read time by one division;
division by a positive constant is monotone, so ``ts`` never goes
backwards within a thread wherever ``ts_ns`` doesn't.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_lock = threading.Lock()
_tls = threading.local()

_ON = False
_EVENTS: List[Dict[str, Any]] = []
_T0_NS = time.perf_counter_ns()
_MAX_EVENTS = 1 << 20          # hard cap: a runaway loop cannot eat the heap


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Start collecting spans (timestamps restart at 0)."""
    global _ON, _T0_NS
    with _lock:
        _T0_NS = time.perf_counter_ns()
        _ON = True


def disable() -> None:
    global _ON
    _ON = False


def reset() -> None:
    """Drop all collected events (enable/disable state unchanged)."""
    with _lock:
        _EVENTS.clear()


def _now_ns() -> int:
    """The tracer clock: integer nanoseconds since the tracer epoch."""
    return time.perf_counter_ns() - _T0_NS


def _now_us() -> float:
    """Derived µs view of the integer clock (export convenience only —
    nothing stores this)."""
    return _now_ns() / 1e3


def _depth() -> int:
    return getattr(_tls, "depth", 0)


def _emit(ev: Dict[str, Any]) -> None:
    with _lock:
        if len(_EVENTS) < _MAX_EVENTS:
            _EVENTS.append(ev)


def _cuda_devices(obj) -> set:
    """The CUDA devices of every tensor in ``obj`` (a tensor, an object
    with a ``device`` attribute such as a SlabGraph, or a list, tuple or
    dict of them)."""
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        out = set()
        for x in obj:
            out |= _cuda_devices(x)
        return out
    dev = getattr(obj, "device", None)
    return {dev} if isinstance(dev, torch.device) and dev.type == "cuda" \
        else set()


class _NoopSpan:
    """The disabled-path span: a shared singleton, no state, no clock."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **tags):
        return self


_NOOP = _NoopSpan()


class Span:
    """One live span: emits a ``B`` event on enter, ``E`` on exit.

    ``sync`` (optional) is a tensor, a SlabGraph, or a list, tuple or dict
    of them: at exit the span synchronises the CUDA device each of them
    lies on, so asynchronously launched work lands inside this span
    instead of whichever span happens to wait for it later.
    """
    __slots__ = ("name", "tags", "sync", "_tid")

    def __init__(self, name: str, sync=None, **tags):
        self.name = name
        self.tags = tags
        self.sync = sync

    def annotate(self, **tags) -> "Span":
        """Attach tags discovered mid-span (they ride the ``E`` event)."""
        self.tags.update(tags)
        return self

    def __enter__(self) -> "Span":
        self._tid = threading.get_ident()
        _tls.depth = _depth() + 1
        _emit({"ph": "B", "name": self.name, "ts_ns": _now_ns(),
               "pid": os.getpid(), "tid": self._tid,
               "args": dict(self.tags) if self.tags else {}})
        return self

    def __exit__(self, *exc) -> bool:
        if self.sync is not None:
            try:
                for dev in _cuda_devices(self.sync):
                    torch.cuda.synchronize(dev)
            except Exception:
                pass               # sync is best-effort attribution only
        _tls.depth = _depth() - 1
        _emit({"ph": "E", "name": self.name, "ts_ns": _now_ns(),
               "pid": os.getpid(), "tid": self._tid,
               "args": dict(self.tags) if self.tags else {}})
        return False


def span(name: str, sync=None, **tags):
    """Context manager for one span; the no-op singleton when tracing is
    off (the zero-overhead fast path — one flag check, nothing else)."""
    if not _ON:
        return _NOOP
    return Span(name, sync=sync, **tags)


def instant(name: str, **tags) -> None:
    """A zero-duration marker event (overflow witness, grow-retry, ...)."""
    if not _ON:
        return
    _emit({"ph": "i", "name": name, "ts_ns": _now_ns(), "pid": os.getpid(),
           "tid": threading.get_ident(), "s": "t",
           "args": dict(tags) if tags else {}})


def events() -> List[Dict[str, Any]]:
    """Collected events with both clocks: the stored integer ``ts_ns``
    and the Chrome-trace ``ts`` (µs) derived from it."""
    with _lock:
        raw = list(_EVENTS)
    return [{**e, "ts": e["ts_ns"] / 1e3} for e in raw]


def export_chrome_trace(path, *, counters: Optional[Dict[str, float]] = None
                        ) -> str:
    """Write the collected spans as Chrome trace-event JSON.

    ``counters`` (name → value, e.g. the metrics registry's kernel
    counters) are appended as ``C`` counter events at the trace tail so
    Perfetto shows them as tracks alongside the spans.
    """
    evs = events()
    if counters:
        ts = evs[-1]["ts"] if evs else _now_us()
        pid = os.getpid()
        for name, value in sorted(counters.items()):
            evs.append({"ph": "C", "name": name, "ts": ts, "pid": pid,
                        "args": {"value": float(value)}})
    payload = {"traceEvents": evs, "displayTimeUnit": "ms"}
    path = str(path)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


__all__ = ["Span", "span", "instant", "enable", "disable", "enabled",
           "reset", "events", "export_chrome_trace"]
