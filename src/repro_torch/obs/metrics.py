"""Process-wide metrics registry: counters, gauges, latency histograms,
structured events.

Every request class and store phase records here when metrics are ON, and
``launch/serve.py --metrics`` reads p50/p95/p99 out of the histograms.

* ``Counter`` / ``Gauge`` — monotonic count / last-value.
* ``Histogram`` — fixed log2-spaced buckets (for export and merging) PLUS
  the raw samples up to a cap, so quantile extraction is EXACT (sorted
  sample selection, not bucket interpolation) for every workload this
  repo runs; past the cap it degrades to bucket-midpoint quantiles and
  says so (``saturated``).
* structured events — an append-only bounded list of dict records (the
  maintenance plane's per-pass events, routing grow-retries, ...).

Module-level helpers (``observe``/``inc``/``set_gauge``/``emit_event``)
are the zero-overhead-when-off surface: first line is a flag check, so a
disabled process pays one branch per call site.  The classes themselves
are flag-free and usable standalone.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

_ON = False
_lock = threading.Lock()

#: default latency bucket ladder: log2 from 1 µs to ~67 s (measurements in
#: SECONDS; bucket i holds samples < 2**i µs).  27 buckets covers every
#: latency this repo can produce.
N_BUCKETS = 27


def enabled() -> bool:
    return _ON


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket latency histogram with exact quantiles.

    Samples are SECONDS.  Buckets are log2 µs rungs (shared ladder across
    every histogram, so exports merge); quantiles come from the retained
    raw samples — exact order statistics — until ``sample_cap`` is hit,
    then from bucket midpoints (``saturated`` flags the degradation).
    """
    __slots__ = ("buckets", "samples", "count", "total", "min", "max",
                 "sample_cap", "saturated")

    def __init__(self, sample_cap: int = 1 << 16):
        self.buckets = [0] * N_BUCKETS
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.sample_cap = sample_cap
        self.saturated = False

    def record(self, seconds: float) -> None:
        v = float(seconds)
        us = v * 1e6
        b = 0
        while b < N_BUCKETS - 1 and us >= (1 << b):
            b += 1
        self.buckets[b] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < self.sample_cap:
            self.samples.append(v)
        else:
            self.saturated = True

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (nearest-rank) from the raw samples; the
        bucket-midpoint estimate once the sample cap saturated."""
        if not self.count:
            return 0.0
        if not self.saturated:
            s = sorted(self.samples)
            k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
            return s[k]
        target = q / 100.0 * self.count
        seen = 0
        for b, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                lo = (1 << (b - 1)) if b else 0.5
                return (lo + (1 << b)) / 2 * 1e-6
        return self.max

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean_s": self.mean,
                "min_s": 0.0 if self.count == 0 else self.min,
                "max_s": 0.0 if self.count == 0 else self.max,
                "p50_s": self.percentile(50), "p90_s": self.percentile(90),
                "p95_s": self.percentile(95), "p99_s": self.percentile(99)}


class MetricsRegistry:
    """Name-keyed metric store (one process-wide instance, see below)."""

    def __init__(self, *, max_events: int = 4096):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._events: List[Dict[str, Any]] = []
        self._event_seq = 0
        self._max_events = max_events

    # -- get-or-create accessors --------------------------------------------
    def counter(self, name: str) -> Counter:
        with _lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with _lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with _lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def event(self, name: str, **fields) -> None:
        with _lock:
            self._event_seq += 1
            ev = {"seq": self._event_seq, "event": name, **fields}
            self._events.append(ev)
            if len(self._events) > self._max_events:
                self._events = self._events[-self._max_events:]

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with _lock:
            return [e for e in self._events
                    if name is None or e["event"] == name]

    # -- export --------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        return {k: c.value for k, c in self._counters.items()}

    def summary(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self._histograms.items()},
            "events": self.events(),
        }

    def render_table(self) -> str:
        """Human summary: histograms as latency rows, then counters/gauges."""
        lines = []
        if self._histograms:
            lines.append(f"{'histogram':40s} {'count':>7s} {'mean':>9s} "
                         f"{'p50':>9s} {'p95':>9s} {'p99':>9s}  (ms)")
            for name in sorted(self._histograms):
                h = self._histograms[name]
                s = h.summary()
                lines.append(
                    f"{name:40s} {s['count']:7d} {s['mean_s'] * 1e3:9.2f} "
                    f"{s['p50_s'] * 1e3:9.2f} {s['p95_s'] * 1e3:9.2f} "
                    f"{s['p99_s'] * 1e3:9.2f}")
        for name in sorted(self._counters):
            lines.append(f"{name:40s} = {self._counters[name].value}")
        for name in sorted(self._gauges):
            lines.append(f"{name:40s} = {self._gauges[name].value:g}")
        return "\n".join(lines)

    def export(self, path) -> str:
        path = str(path)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, default=str)
        return path

    def reset(self) -> None:
        with _lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._events.clear()
            self._event_seq = 0


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# ----------------------------------------------------------------------------
# zero-overhead-when-off call-site helpers
# ----------------------------------------------------------------------------

def inc(name: str, n: int = 1) -> None:
    if not _ON:
        return
    _REGISTRY.counter(name).inc(n)


def set_gauge(name: str, value: float) -> None:
    if not _ON:
        return
    _REGISTRY.gauge(name).set(value)


def observe(name: str, seconds: float) -> None:
    if not _ON:
        return
    _REGISTRY.histogram(name).record(seconds)


def emit_event(name: str, **fields) -> None:
    if not _ON:
        return
    _REGISTRY.event(name, **fields)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "N_BUCKETS",
           "enable", "disable", "enabled", "get_registry",
           "inc", "set_gauge", "observe", "emit_event"]
