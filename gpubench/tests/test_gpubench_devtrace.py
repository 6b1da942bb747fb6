"""The device trace's arithmetic (busy time, idle gaps, time by name and
by group) and the labelling of idle time by host span, against plain
loops over the same intervals."""
import random

from gpubench.harness.devtrace import DeviceTrace
from gpubench.harness.spans import label_time

WINDOW = (0, 10 ** 6 + 5000)


def trace(seed=1, n=2000):
    rnd = random.Random(seed)
    ops = []
    for i in range(n):
        s = rnd.randint(0, 10 ** 6)
        ops.append((f"k{i % 7}", s, s + rnd.randint(1, 2000)))
    names = sorted({o[0] for o in ops})
    dev = DeviceTrace(names, [names.index(o[0]) for o in ops],
                      [o[1] for o in ops], [o[2] for o in ops], WINDOW)
    return dev, ops


def plain_merged(ops):
    out = []
    for s, e in sorted((s, e) for _, s, e in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def test_busy_and_gaps():
    dev, ops = trace()
    merged = plain_merged(ops)
    assert dev.busy_ns() == sum(e - s for s, e in merged)
    gaps, at = [], WINDOW[0]
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    gaps.append((at, WINDOW[1]))
    assert dev.gaps() == gaps


def test_time_by_name_and_group():
    dev, ops = trace(2)
    want = {}
    for name, s, e in ops:
        want[name] = want.get(name, 0) + e - s
    assert dev.time_by_name() == want
    until = 500_000
    grouped = sum(min(e, until) - s for name, s, e in ops
                  if name in ("k1", "k2") and s < until)
    got = dev.time_by_group(lambda n: "a" if n in ("k1", "k2") else None,
                            until)
    assert got == {"a": grouped}


def test_idle_time_by_span_label():
    dev, _ = trace(3)
    rnd = random.Random(4)
    segs, at = [], 0
    for j in range(300):
        nxt = min(at + rnd.randint(1, 7000), WINDOW[1])
        segs.append((at, nxt, f"s{j % 5}"))
        at = nxt
    want = {}
    for gs, ge in dev.gaps():
        for s, e, name in segs:
            overlap = min(e, ge) - max(s, gs)
            if overlap > 0:
                want[name] = want.get(name, 0) + overlap
    assert label_time(dev.gaps(), segs) == want
