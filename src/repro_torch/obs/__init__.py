"""The telemetry plane: tracing, metrics, the flight recorder and crash
post-mortems, OFF by default (the flight recorder aside) with a one-branch
no-op fast path at every call site.  Pools are bit-identical with
telemetry on or off.

* ``trace``      - nestable spans (store version, epoch phase, pool-shape
  tags), Chrome trace-event JSON export for Perfetto;
* ``metrics``    - process-wide counters, gauges, latency histograms with
  exact p50/p95/p99, a structured event stream;
* ``flight``     - the always-on ring of compact events (the black box);
* ``postmortem`` - the bundle a dying apply writes beside its WAL;
* ``instrument`` - ``@timed_dispatch`` on the kernel families' entry
  points: calls, first-call and steady times, bytes per pool shape;
* ``health``     - SLO targets, windowed burn rates and ``HealthReport``.

``obs.enable()`` arms tracing and metrics; ``obs.disable()`` restores the
no-op fast path.  ``launch/serve.py --trace out.json / --metrics`` is the
serving surface.
"""
from __future__ import annotations

from . import flight, health, instrument, metrics, postmortem, trace
from .health import HealthEngine, HealthReport, SLOTarget
from .instrument import (kernel_stats, kernel_summary, pool_bytes,
                         reset_kernel_stats, timed_dispatch)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, emit_event,
                      get_registry, inc, observe, set_gauge)
from .trace import Span, export_chrome_trace, instant, span


def enable(*, tracing: bool = True, metric: bool = True) -> None:
    """Arm the telemetry plane (both sides by default)."""
    if tracing:
        trace.enable()
    if metric:
        metrics.enable()


def disable() -> None:
    """Back to the no-op fast path (collected data is kept until reset).
    The flight recorder stays on: strip it with ``flight.disable()``."""
    trace.disable()
    metrics.disable()


def enabled() -> bool:
    return trace.enabled() or metrics.enabled()


def reset() -> None:
    """Drop every collected span, metric, kernel stat and flight event (the
    flight ring is emptied but stays armed)."""
    trace.reset()
    get_registry().reset()
    reset_kernel_stats()
    flight.reset()


__all__ = [
    "trace", "metrics", "instrument", "flight", "health", "postmortem",
    "enable", "disable", "enabled", "reset",
    "Span", "span", "instant", "export_chrome_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "inc", "observe", "set_gauge", "emit_event",
    "SLOTarget", "HealthEngine", "HealthReport",
    "timed_dispatch", "pool_bytes", "kernel_stats", "kernel_summary",
    "reset_kernel_stats",
]
