"""``@timed_dispatch``: instrumentation of the kernel families' entry points.

Wraps the public entry points of the slab kernel families
(``slab_update``, ``slab_sweep``, ``slab_compact``, ``slab_intersect``
``ops.py``) and records, per (family, op, pool shape):

* the call count,
* the first call's time per shape, kept apart from the steady calls (the
  first call of a process builds or loads the CUDA library, so it never
  pollutes the steady times),
* a bytes estimate: the tensor leaves of the arguments plus those of the
  result.

The wrapper never changes what the wrapped function computes.  Off (no
tracing, metrics or flight recorder), it is one flag check and a tail
call.  With the flight recorder only (the default: the black box is
always on) it writes one ring event per outermost dispatch with the host
time of the call, and never waits for the device.  With metrics or
tracing on it times the call: on CUDA tensors with ``torch.cuda.Event``s
recorded around it on the current stream, then waits on the end event;
on CPU tensors with ``perf_counter``.

Two guards:

* a trace guard: under ``torch.jit`` tracing, ``torch.compile`` and CUDA
  graph capture a clock means nothing and a wait would break the capture,
  so the wrapper steps aside;
* a re-entrancy guard: ``sweep_vertices`` calls ``sweep_partials``, the
  multi-view and stacked entry points call the per-graph ones; only the
  outermost instrumented dispatch records, so one call counts once.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import flight, metrics, trace

_tls = threading.local()
_lock = threading.Lock()

#: (family, op, shape signature) -> stats record
_KERNEL_STATS: Dict[Tuple[str, str, str], Dict[str, float]] = {}


def _tracing() -> bool:
    """Inside a ``torch.jit`` trace, a ``torch.compile`` region or a CUDA
    graph capture."""
    if torch.jit.is_tracing():
        return True
    compiler = getattr(torch, "compiler", None)
    if compiler is not None and compiler.is_compiling():
        return True
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of ``tree``: tensors, graphs (``SlabGraph`` and
    other dataclasses, a ``ShardedSlabGraph``'s stacked pools), tuples,
    lists and dict values."""
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def pool_bytes(tree) -> int:
    """Total bytes of every tensor leaf in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _shape_sig(args) -> str:
    """Pool-shape signature: the first graph argument's key-pool shape
    (stacked pools keep their shard axis), else the first tensor leaf's."""
    for a in args:
        keys = getattr(a, "keys", None)
        if isinstance(keys, torch.Tensor):
            return "x".join(str(d) for d in keys.shape)
        graphs = getattr(a, "graphs", None)          # ShardedSlabGraph
        if isinstance(getattr(graphs, "keys", None), torch.Tensor):
            return "x".join(str(d) for d in graphs.keys.shape)
    ts = _tensors(args)
    if ts:
        return "x".join(str(d) for d in ts[0].shape) or "scalar"
    return "scalar"


def kernel_stats() -> Dict[Tuple[str, str, str], Dict[str, float]]:
    with _lock:
        return {k: dict(v) for k, v in _KERNEL_STATS.items()}


def kernel_summary() -> Dict[str, Dict[str, float]]:
    """JSON-friendly per ``family.op[shape]`` record: calls, first-call s,
    steady calls and s, measured bytes."""
    out = {}
    for (family, op, shape), s in kernel_stats().items():
        out[f"{family}.{op}[{shape}]"] = {
            "family": family, "op": op, "shape": shape,
            "calls": int(s["calls"]),
            "compile_s": s["compile_s"],
            "steady_calls": int(s["steady_calls"]),
            "steady_s": s["steady_s"],
            "bytes": int(s["bytes"]),
        }
    return out


def reset_kernel_stats() -> None:
    with _lock:
        _KERNEL_STATS.clear()


def _record(family: str, op: str, shape: str, dt_s: float,
            nbytes: int) -> None:
    key = (family, op, shape)
    with _lock:
        s = _KERNEL_STATS.get(key)
        if s is None:
            s = _KERNEL_STATS[key] = {"calls": 0, "compile_s": 0.0,
                                      "steady_calls": 0, "steady_s": 0.0,
                                      "bytes": 0}
        first = s["calls"] == 0
        s["calls"] += 1
        if first:
            # the first dispatch per pool shape builds or loads the library
            s["compile_s"] = dt_s
        else:
            s["steady_calls"] += 1
            s["steady_s"] += dt_s
            s["bytes"] += nbytes
    name = f"kernel.{family}.{op}"
    metrics.inc(f"{name}.calls")
    if first:
        metrics.observe(f"{name}.compile", dt_s)
    else:
        metrics.inc(f"{name}.bytes", nbytes)
        metrics.observe(f"{name}.run", dt_s)


def _cuda_device(args) -> Optional[torch.device]:
    for t in _tensors(args):
        return t.device if t.is_cuda else None
    return None


def timed_dispatch(family: str, op: Optional[str] = None,
                   bytes_fn: Optional[Callable] = None):
    """Decorator factory for kernel-family entry points (module doc).
    ``bytes_fn(args, kwargs, out)``, when given, is a call's byte count in
    place of the pools' leaf sum."""

    def deco(fn):
        op_name = op or fn.__name__
        # one flight code per entry point: the flight-only path is a ring
        # write keyed by it, no lookup per dispatch
        fl_code = flight.intern(f"kernel.{family}.{op_name}")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (metrics.enabled() or trace.enabled()
                    or flight.enabled()):
                return fn(*args, **kwargs)
            if getattr(_tls, "depth", 0) > 0 or _tracing():
                return fn(*args, **kwargs)
            if not (metrics.enabled() or trace.enabled()):
                # flight only: one ring write, no shape signature and no
                # wait on the device
                _tls.depth = 1
                try:
                    t0 = time.perf_counter_ns()
                    out = fn(*args, **kwargs)
                    flight.record(fl_code, time.perf_counter_ns() - t0)
                finally:
                    _tls.depth = 0
                return out
            _tls.depth = 1
            try:
                shape = _shape_sig(args)
                dev = _cuda_device(args)
                t0 = time.perf_counter_ns()
                with trace.span(f"kernel.{family}.{op_name}", shape=shape):
                    if dev is None:
                        out = fn(*args, **kwargs)
                        dt_ns = time.perf_counter_ns() - t0
                    else:
                        stream = torch.cuda.current_stream(dev)
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record(stream)
                        out = fn(*args, **kwargs)
                        end.record(stream)
                        end.synchronize()
                        dt_ns = int(1e6 * start.elapsed_time(end))
                flight.record(fl_code, dt_ns)
                if bytes_fn is not None:
                    nbytes = int(bytes_fn(args, kwargs, out))
                else:
                    nbytes = pool_bytes(args) + pool_bytes(out)
                _record(family, op_name, shape, dt_ns / 1e9, nbytes)
            finally:
                _tls.depth = 0
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    return deco


__all__ = ["timed_dispatch", "pool_bytes", "kernel_stats", "kernel_summary",
           "reset_kernel_stats"]
