"""The window's arithmetic reacts to a stall planted in the window."""
import pytest

from gpubench.harness import stats
from gpubench.harness.cell import Manifest
from gpubench.tests._tiny import REPO

CLIENT = Manifest(REPO).client({"client": "closed_rounds"})


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def window(stall_every):
    clock = Clock()

    def round_fn(i):
        t0 = clock.t
        clock.t += 0.100 + (0.150 if stall_every and i % stall_every == 0
                            else 0.0)
        t1 = clock.t
        clock.t += 0.002
        return t0, t1, clock.t

    win, rounds = CLIENT.run_window(round_fn, 30.0, clock)
    return CLIENT.window_metrics(win, rounds, 65536)


def test_planted_stall_moves_both_metrics():
    clean, stalled = window(0), window(10)
    assert stalled["fresh_p95_ms"] > clean["fresh_p95_ms"] + 100
    assert stalled["fresh_edges_per_s"] < 0.9 * clean["fresh_edges_per_s"]
    assert clean["fresh_p95_ms"] == pytest.approx(100.0)
    assert clean["rounds"] == 294     # rounds that end inside 30 s
    assert clean["fresh_edges_per_s"] == pytest.approx(294 * 65536 / 30)


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)
