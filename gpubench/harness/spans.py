"""Closed spans from the program's tracer (``repro_torch.obs.trace``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int]          # None while open
    args: Dict
    parent: Optional[int]          # index of the enclosing span

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def all_spans(events: List[Dict]) -> List[Span]:
    """Pair the tracer's ``B``/``E`` events per thread into spans; the
    ``E`` event's tags (set during the span) join the ``B``'s.  A span
    never closed keeps ``end_ns`` None."""
    out: List[Span] = []
    stacks: Dict[int, List[int]] = {}
    for ev in events:
        stack = stacks.setdefault(ev["tid"], [])
        if ev["ph"] == "B":
            out.append(Span(ev["name"], ev["ts_ns"], None, dict(ev["args"]),
                            stack[-1] if stack else None))
            stack.append(len(out) - 1)
        elif ev["ph"] == "E" and stack:
            sp = out[stack.pop()]
            sp.end_ns = ev["ts_ns"]
            sp.args.update(ev["args"])
    return out


def closed(spans: List[Span], name: str) -> List[Span]:
    return [s for s in spans if s.name == name and s.end_ns is not None]


def host_segments(events: List[Dict], lo: int, hi: int, *,
                  idle_label: str = "harness"
                  ) -> List[Tuple[int, int, str]]:
    """The window ``[lo, hi)`` cut where the innermost open span changes,
    each piece labelled with that span's name (``idle_label`` outside
    every span).  Events are in one clock with ``lo`` and ``hi``."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[str] = []
    at = lo
    for ev in events:
        if ev["ph"] not in ("B", "E"):
            continue
        t = min(max(ev["ts_ns"], lo), hi)
        if t > at:
            segs.append((at, t, stack[-1] if stack else idle_label))
            at = t
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif stack:
            stack.pop()
    if hi > at:
        segs.append((at, hi, stack[-1] if stack else idle_label))
    return segs


def label_time(gaps: List[Tuple[int, int]],
               segs: List[Tuple[int, int, str]]) -> Dict[str, int]:
    """Nanoseconds of ``gaps`` under each segment label (both sorted, each
    list's intervals disjoint)."""
    if not gaps or not segs:
        return {}
    gs, ge = (np.asarray(x, dtype=np.int64) for x in zip(*gaps))
    before = np.concatenate([[0], np.cumsum(ge - gs)])

    def idle_until(t):
        i = np.searchsorted(gs, t, side="right") - 1
        inside = np.clip(t - gs[np.maximum(i, 0)], 0,
                         (ge - gs)[np.maximum(i, 0)])
        return np.where(i >= 0, before[np.maximum(i, 0)] + inside, 0)

    ss, se, names = zip(*segs)
    idle = (idle_until(np.asarray(se, dtype=np.int64))
            - idle_until(np.asarray(ss, dtype=np.int64)))
    out: Dict[str, int] = {}
    for name, ns in zip(names, idle.tolist()):
        if ns > 0:
            out[name] = out.get(name, 0) + int(ns)
    return out
