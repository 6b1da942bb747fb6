"""Port parity for the maintenance policy: each trigger of
``MaintenancePolicy`` armed alone on a reference ``GraphStore`` and on a port
``GraphStore`` (CPU), the same churn through both.

After every epoch the three views are leaf-identical and the maintenance
counters and per-pass events (action, trigger text, tombstone ratio,
capacity movement, slabs reclaimed) are equal; each case also checks that
its trigger fired.  Everything here is integer or compared as text: no
tolerance.
"""
import numpy as np
import pytest

from _torch_port import assert_maintenance_equal, assert_pools_equal

from repro import stream as jstream
from repro_torch import stream as tstream

V = 300
N_HUBS = 4
EPOCHS = 6

#: policy fields, then the action and trigger prefix each case must see;
#: thresholds sit between the built pool's stats and where the churn below
#: takes them (mean chain 1.027 -> 1.047, occupancy 0.068 -> 0.058, dead
#: slabs 0 -> 5, tombstone ratio 0 -> 0.37)
CASES = {
    "every": (dict(tombstone_ratio=0.0, every=3), "compact", "every="),
    "max_mean_chain": (dict(tombstone_ratio=0.0, max_mean_chain=1.038),
                       "compact", "mean_chain"),
    "min_occupancy": (dict(tombstone_ratio=0.0, min_occupancy=0.061),
                      "compact", "occupancy"),
    "reclaim_dead_slabs": (dict(tombstone_ratio=0.0, reclaim_dead_slabs=3),
                           "reclaim", "dead_slabs"),
    "tombstone_ratio": (dict(tombstone_ratio=0.2, slack_slabs=16),
                        "compact", "tombstone_ratio"),
    "shrink_occupancy": (dict(tombstone_ratio=0.2, shrink_occupancy=0.0),
                         "compact", "tombstone_ratio"),
}


def _graph(rng):
    """Four hubs with an edge to every vertex (three slabs each, hashing
    off) beside 1,500 random edges."""
    hs = np.repeat(np.arange(N_HUBS), V)
    hd = np.tile(np.arange(V), N_HUBS)
    rs, rd = rng.integers(0, V, (2, 1500))
    return (np.concatenate([hs, rs]).astype(np.uint32),
            np.concatenate([hd, rd]).astype(np.uint32))


def _epochs(rng, src, dst):
    """Each epoch deletes every edge of one hub (wholly dead overflow
    slabs) and 48 random edges, and inserts 96 random edges and 160 out of
    a fresh vertex (one more overflow slab)."""
    out = []
    for e in range(EPOCHS):
        di = rng.choice(len(src) - N_HUBS * V, 48, replace=False) \
            + N_HUBS * V
        d_s = np.concatenate([np.full(V, e % N_HUBS), src[di]])
        d_d = np.concatenate([np.arange(V), dst[di]])
        i_s = np.concatenate([rng.integers(0, V, 96), np.full(160, 10 + e)])
        i_d = np.concatenate([rng.integers(0, V, 96),
                              rng.permutation(V)[:160]])
        out.append(tuple(a.astype(np.uint32) for a in (i_s, i_d, d_s, d_d)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_policy_trigger_matches_reference(case):
    fields, action, prefix = CASES[case]
    rng = np.random.default_rng(7)
    src, dst = _graph(rng)
    kw = dict(hashing=False, slack_slabs=1024)
    js = jstream.GraphStore.from_edges(
        V, src, dst, maintenance=jstream.MaintenancePolicy(**fields), **kw)
    ts = tstream.GraphStore.from_edges(
        V, src, dst, maintenance=tstream.MaintenancePolicy(**fields),
        device="cpu", **kw)
    for e, (i_s, i_d, d_s, d_d) in enumerate(_epochs(rng, src, dst)):
        jb = js.apply(ins_src=i_s, ins_dst=i_d, del_src=d_s, del_dst=d_d)
        tb = ts.apply(ins_src=i_s, ins_dst=i_d, del_src=d_s, del_dst=d_d)
        what = f"{case}, epoch {e}"
        assert (tb.n_inserted, tb.n_deleted) == \
            (jb.n_inserted, jb.n_deleted), what
        for view in ("forward", "transpose", "symmetric"):
            assert_pools_equal(ts.views[view], js.views[view],
                               f"{what}: {view}")
        assert_maintenance_equal(ts, js, what)
    events = ts.maintenance_events
    fired = [ev for ev in events if ev["trigger"].startswith(prefix)]
    assert fired and all(ev["action"] == action for ev in fired), events
    if case == "shrink_occupancy":
        assert all(ev["capacity_after"] == ev["capacity_before"]
                   for ev in events)
    if case == "tombstone_ratio":
        assert any(ev["capacity_after"] < ev["capacity_before"]
                   for ev in events)
    if action == "reclaim":
        assert sum(ev["slabs_reclaimed"] for ev in events) > 0


def test_forced_maintenance_matches_reference():
    """``maintain(action=...)`` with no policy attached: a reclaim, then a
    compaction, with equal records and pools."""
    rng = np.random.default_rng(8)
    src, dst = _graph(rng)
    js = jstream.GraphStore.from_edges(V, src, dst, hashing=False)
    ts = tstream.GraphStore.from_edges(V, src, dst, hashing=False,
                                       device="cpu")
    for i_s, i_d, d_s, d_d in _epochs(rng, src, dst)[:3]:
        js.apply(ins_src=i_s, ins_dst=i_d, del_src=d_s, del_dst=d_d)
        ts.apply(ins_src=i_s, ins_dst=i_d, del_src=d_s, del_dst=d_d)
    for action in ("reclaim", "compact"):
        jr, tr = js.maintain(action=action), ts.maintain(action=action)
        assert (tr.action, tr.trigger, tr.reclaimed) == \
            (jr.action, jr.trigger, jr.reclaimed), action
        for view in ("forward", "transpose", "symmetric"):
            assert_pools_equal(ts.views[view], js.views[view],
                               f"{action}: {view}")
        assert_maintenance_equal(ts, js, action)
    assert ts.pool_stats()["tombstone_lanes"] == 0
    assert tr.scan_s > 0.0


def test_decide_and_shrink_gate_match_reference():
    """The policy's decision and shrink gate on a grid of stats: trigger
    order, thresholds met exactly, disabled triggers."""
    grid = [dict(tombstone_ratio=t, mean_chain=c, occupancy=o, dead_slabs=d,
                 allocated_slabs=a, capacity_slabs=64)
            for t in (0.0, 0.25, 0.4) for c in (1.0, 2.0)
            for o in (0.05, 0.5) for d in (0, 8) for a in (16, 48)]
    policies = [dict(), dict(tombstone_ratio=0.0),
                dict(every=4, max_mean_chain=2.0),
                dict(tombstone_ratio=0.3, min_occupancy=0.1,
                     reclaim_dead_slabs=8, shrink_occupancy=0.5)]
    for fields in policies:
        jp = jstream.MaintenancePolicy(**fields)
        tp = tstream.MaintenancePolicy(**fields)
        for stats in grid:
            for since in (3, 4):
                assert tp.decide(stats, epochs_since=since) == \
                    jp.decide(stats, epochs_since=since), (fields, stats)
            assert tp.allow_shrink(stats) == jp.allow_shrink(stats)
