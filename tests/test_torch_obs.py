"""Port parity for the telemetry plane: metrics, spans, the flight recorder
and crash post-mortems, against the reference's ``repro.obs``.

* Histograms give the reference's p50/p95/p99 (and summaries) for the
  same observations, exact and saturated.
* Spans pair up and export the reference's Chrome schema; a span's
  ``sync`` accepts the port's tensors and graphs.
* Flight snapshots and post-mortem bundles carry the reference's keys; a
  kill at each apply site leaves a bundle beside the WAL that ``recover``
  reads back, as in the reference.
* Pools are bit-identical with tracing and metrics on or off.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import resilience as jrz
from repro import stream as jstream
from repro.obs import flight as jflight
from repro.obs import postmortem as jpostmortem
from repro.resilience import faults as jfaults
from repro_torch import obs
from repro_torch import resilience as rz
from repro_torch.core.slab_graph import FIELDS
from repro_torch.obs import flight, postmortem
from repro_torch.resilience import faults
from repro_torch.stream import (GraphStore, MaintenancePolicy,
                                PropertyRegistry)

V = 96
APPLY_SITES = ("apply.admitted", "store.capacity_grow", "apply.post_wal",
               "apply.pre_close", "apply.post_close")


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jobs):
        o.disable()
        o.reset()
    for m in (faults, jfaults, postmortem, jpostmortem):
        m.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()
    for m in (faults, jfaults, postmortem, jpostmortem):
        m.reset()


@pytest.mark.parametrize("cap,samples", [
    (1 << 16, [v / 1000.0 for v in range(1, 101)]),
    (1 << 16, list(np.random.default_rng(0).lognormal(-6, 2, 997))),
    (8, [0.001] * 50 + [0.016] * 50),
])
def test_histogram_matches_reference(cap, samples):
    h, j = obs.Histogram(sample_cap=cap), jobs.Histogram(sample_cap=cap)
    for v in samples:
        h.record(v)
        j.record(v)
    for q in (50, 90, 95, 99):
        assert h.percentile(q) == j.percentile(q)
    assert h.summary() == j.summary()
    assert h.buckets == j.buckets and h.saturated == j.saturated


def test_registry_and_helpers_match_reference():
    for o in (obs, jobs):
        o.inc("never")
        assert o.get_registry().counters() == {}
        o.metrics.enable()
        o.inc("a")
        o.inc("a", 4)
        o.set_gauge("g", 2.5)
        o.observe("lat", 0.002)
        o.emit_event("ping", shard=3)
    got, want = obs.get_registry().summary(), jobs.get_registry().summary()
    assert got == want
    table = obs.get_registry().render_table()
    assert table == jobs.get_registry().render_table()
    assert "p99" in table


def test_spans_pair_and_export_reference_schema(tmp_path):
    assert obs.span("a", version=1) is obs.span("b")     # the shared noop
    obs.trace.enable()
    g = torch.zeros(3)
    with obs.span("outer", version=3, sync=(g, {"x": g})):
        with obs.span("inner") as sp:
            sp.annotate(inserted=7)
            obs.instant("witness", over=2)
    evs = obs.trace.events()
    assert [e["ph"] for e in evs] == ["B", "B", "i", "E", "E"]
    assert evs[0]["args"]["version"] == 3
    assert evs[3]["args"]["inserted"] == 7
    path = obs.export_chrome_trace(tmp_path / "t.json",
                                   counters={"kernel.calls": 5})
    doc = json.loads(open(path).read())
    jobs.trace.enable()
    with jobs.span("outer", version=3):
        with jobs.span("inner"):
            jobs.instant("witness", over=2)
    jdoc = json.loads(open(jobs.export_chrome_trace(
        tmp_path / "j.json", counters={"kernel.calls": 5})).read())
    assert set(doc) == set(jdoc)
    assert [sorted(e) for e in doc["traceEvents"]] == \
        [sorted(e) for e in jdoc["traceEvents"]]


def test_flight_snapshot_and_export_match_reference(tmp_path):
    for f in (flight, jflight):
        f.reset()
        f.note("unit.a", 1, 2, 3)
        f.note("unit.b", 4)
    got, want = flight.snapshot(), jflight.snapshot()
    assert [(e["event"], e["a"], e["b"], e["c"]) for e in got] == \
        [(e["event"], e["a"], e["b"], e["c"]) for e in want]
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    assert flight.stats().keys() == jflight.stats().keys()
    doc = json.loads(open(flight.export_chrome_trace(
        tmp_path / "f.json")).read())
    jdoc = json.loads(open(jflight.export_chrome_trace(
        tmp_path / "jf.json")).read())
    assert set(doc) == set(jdoc)


def _keys(d, depth=2):
    """The nested key structure of a bundle, ``depth`` levels down."""
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_postmortem_units(tmp_path):
    flight.note("test.before_death", 42)
    p = postmortem.dump(None, reason="unit_test", bundle_dir=tmp_path)
    doc = postmortem.latest(tmp_path)
    assert doc["schema"] == postmortem.SCHEMA == jpostmortem.SCHEMA
    assert any(e["event"] == "test.before_death"
               for e in doc["flight"]["events"])
    jp = jpostmortem.dump(None, reason="unit_test",
                          bundle_dir=tmp_path / "ref")
    assert _keys(json.loads(p.read_text())) == \
        _keys(json.loads(jp.read_text()))
    assert postmortem.consume_latest(tmp_path)["reason"] == "unit_test"
    assert postmortem.latest(tmp_path) is None
    assert postmortem.dump(None, reason="nowhere") is None
    postmortem.set_bundle_dir(tmp_path / "fb")
    assert postmortem.on_apply_failure(
        None, rz.InjectedOOM("store.capacity_grow", 1)) is None
    assert postmortem.on_apply_failure(None, ValueError("x")) is not None
    br = rz.CircuitBreaker(threshold=3, cooldown=4)
    postmortem.register_breaker(br)
    postmortem.register_breaker(br)
    doc = json.loads(postmortem.dump(None, reason="t",
                                     bundle_dir=tmp_path).read_text())
    assert doc["breakers"] == [br.status()]


def _seed_store(pkg):
    rng = np.random.default_rng(3)
    src = rng.integers(0, V, 400).astype(np.uint32)
    dst = rng.integers(0, V, 400).astype(np.uint32)
    if pkg == "torch":
        return GraphStore.from_edges(
            V, src, dst, device="cpu",
            maintenance=MaintenancePolicy(tombstone_ratio=0.15))
    return jstream.GraphStore.from_edges(
        V, src, dst, maintenance=jstream.MaintenancePolicy(
            tombstone_ratio=0.15))


def _kill(pkg, site, tmp_path):
    """Apply four batches (a checkpoint after the first), the last under a
    kill at ``site``; the bundle the crash left beside the WAL."""
    r, f, pm = (rz, faults, postmortem) if pkg == "torch" else \
        (jrz, jfaults, jpostmortem)
    wd, ck = tmp_path / pkg / "wal", tmp_path / pkg / "ck"
    store = _seed_store(pkg).attach_wal(r.WriteAheadLog(wd))
    rng = np.random.default_rng(13)
    with pytest.raises(r.InjectedCrash):
        for t in range(4):
            b = [rng.integers(0, V, n).astype(np.uint32)
                 for n in (60, 60, 12, 12)]
            if t == 1:
                store.save(ck)
            with (f.inject(r.FaultSpec(site, at=1)) if t == 3
                  else contextlib.nullcontext()):
                store.apply(b[0], b[1], None, b[2], b[3])
    store.wal.close()
    return pm.latest(wd / "postmortem"), wd, ck


@pytest.mark.parametrize("site", APPLY_SITES)
def test_kill_leaves_reference_bundle_and_recover_reads_it(site, tmp_path):
    doc, wd, ck = _kill("torch", site, tmp_path)
    jdoc, _, _ = _kill("jax", site, tmp_path)
    assert doc["reason"] == jdoc["reason"] == "injected_crash"
    assert doc["exception"] == jdoc["exception"]
    assert doc["exception"]["site"] == site
    assert doc["store"]["kind"] == jdoc["store"]["kind"] == "GraphStore"
    assert doc["store"]["resilience_meta"] == \
        jdoc["store"]["resilience_meta"]
    assert doc["fault_plan"] == jdoc["fault_plan"]
    assert _keys(doc, 1) == _keys(jdoc, 1)
    assert set(doc["store"]) == set(jdoc["store"])
    names = {e["event"] for e in doc["flight"]["events"]}
    assert {"store.apply.admitted", "fault.fired"} <= names
    store2, _, report = rz.recover(
        ck, wd, maintenance=MaintenancePolicy(tombstone_ratio=0.15),
        device="cpu")
    assert report.crash_reason == f"injected_crash@{site}"
    assert report.postmortem["exception"]["site"] == site
    assert postmortem.latest(wd / "postmortem") is None


def test_pools_identical_with_telemetry_on_and_off():
    def drive(on):
        if on:
            obs.enable()
        store = _seed_store("torch")
        registry = PropertyRegistry(store)
        from repro_torch.algorithms import pagerank_stream_property
        registry.register(pagerank_stream_property())
        rng = np.random.default_rng(17)
        for _ in range(4):
            b = [rng.integers(0, V, n).astype(np.uint32)
                 for n in (60, 60, 12, 12)]
            store.apply(b[0], b[1], None, b[2], b[3])
        registry.read("pagerank")
        obs.disable()
        return store
    off, on = drive(False), drive(True)
    counters = obs.get_registry().counters()
    assert counters["store.apply.epochs"] == 4
    assert any(e["name"] == "store.apply.dispatch"
               for e in obs.trace.events())
    for name in off.views:
        for f in FIELDS:
            a, b = getattr(off.views[name], f), getattr(on.views[name], f)
            assert (a is None and b is None) or torch.equal(a, b), (name, f)
