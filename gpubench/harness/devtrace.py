"""The device trace of a traced window: what ran on the card, and when.

``torch.profiler`` records the card's activity (kernels, copies, sets)
through CUPTI; the host's own operators are not recorded, so the trace
costs the host little.  Its timestamps (Unix-epoch ns) are mapped onto
the host's ``perf_counter_ns`` clock, so that idle gaps can be set beside
the spans the host was in.  A window holds some hundred thousand
activities, so they are kept as arrays.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class DeviceTrace:
    """Device activities in host ``perf_counter_ns`` time, clipped to the
    window: ``names`` (distinct), and per activity its name's ``code``,
    ``start`` and ``end``."""

    def __init__(self, names: List[str], code, start, end,
                 window: Tuple[int, int], n_recorded: int = 0):
        self.names = names
        self.code = np.asarray(code, dtype=np.int64)
        self.start = np.asarray(start, dtype=np.int64)
        self.end = np.asarray(end, dtype=np.int64)
        self.window = window
        self.n_recorded = n_recorded          # recorded, in the window or not
        self._merged = None

    def __len__(self) -> int:
        return int(self.code.size)

    def merged(self) -> Tuple[np.ndarray, np.ndarray]:
        """The union of the activities' intervals, in order."""
        if self._merged is None:
            order = np.argsort(self.start, kind="stable")
            s, e = self.start[order], self.end[order]
            reach = np.maximum.accumulate(e) if e.size else e
            new = np.ones(s.size, dtype=bool)
            new[1:] = s[1:] > reach[:-1]
            first = np.flatnonzero(new)
            last = np.append(first[1:], s.size) - 1
            self._merged = (s[first], reach[last])
        return self._merged

    def busy_ns(self) -> int:
        """Time in which at least one activity ran."""
        s, e = self.merged()
        return int((e - s).sum())

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle stretches of the window between activities."""
        s, e = self.merged()
        lo, hi = self.window
        starts = np.concatenate([[lo], e])
        ends = np.concatenate([s, [hi]])
        keep = ends > starts
        return list(zip(starts[keep].tolist(), ends[keep].tolist()))

    def time_by_name(self) -> Dict[str, int]:
        ns = np.bincount(self.code, weights=self.end - self.start,
                         minlength=len(self.names))
        return {n: int(t) for n, t in zip(self.names, ns) if t > 0}

    def time_by_group(self, group, until: int) -> Dict[str, int]:
        """Device time per group of activities that start before
        ``until``, clipped to it; ``group(name)`` gives a name's group or
        None."""
        end = np.minimum(self.end, until)
        ns = np.bincount(self.code, weights=np.maximum(end - self.start, 0),
                         minlength=len(self.names))
        out: Dict[str, int] = {}
        for name, t in zip(self.names, ns):
            g = group(name)
            if g is not None and t > 0:
                out[g] = out.get(g, 0) + int(t)
        return out


def start():
    """A running device profiler, or None where there is no card."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof, window: Tuple[int, int]) -> Optional[DeviceTrace]:
    """Stop ``prof`` and read its device activities inside ``window``
    (host ``perf_counter_ns``)."""
    if prof is None:
        return None
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    # Kineto stamps device activity in Unix-epoch ns (CLOCK_REALTIME);
    # perf_counter_ns is CLOCK_MONOTONIC: one offset maps the one onto the
    # other, read back to back
    off = time.time_ns() - time.perf_counter_ns()
    lo, hi = window
    codes: Dict[str, int] = {}
    code, start_ns, dur = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        code.append(codes.setdefault(ev.name(), len(codes)))
        start_ns.append(ev.start_ns())
        dur.append(ev.duration_ns())
    s = np.asarray(start_ns, dtype=np.int64) - off
    e = s + np.asarray(dur, dtype=np.int64)
    s, e = np.maximum(s, lo), np.minimum(e, hi)
    keep = e > s
    return DeviceTrace(list(codes), np.asarray(code, dtype=np.int64)[keep],
                       s[keep], e[keep], window, len(code))
