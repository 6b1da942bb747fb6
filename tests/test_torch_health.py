"""Port parity for the SLO health engine and the burn-rate half of the
circuit breaker, against the reference's ``repro.obs.health`` and
``repro.resilience.guard``.

* Given the same request samples (latencies, errors), the same store
  samples and the same staleness, ``HealthReport.as_dict()`` is equal
  between the packages: burn rates, p50 and max, the pool trend, the
  staleness and ``healthy`` (the arithmetic is numpy float64 in both, so
  equality is exact), and ``render()`` gives the same text.
* The breaker's burn trips and ``status()`` follow the same reports to the
  same states.
* A pipeline with ``health=`` reports on the reference's cadence
  (``health_every``), samples every request class, and sheds the same
  updates once the burn rate trips its breaker.
* The store sample after a failed apply (the engine ran, then a fault)
  equals the reference's, for both store kinds.
"""
import types

import numpy as np
import pytest

from repro import obs as jobs
from repro import resilience as jrz
from repro import stream as jstream
from repro.obs import flight as jflight
from repro.obs.health import HealthEngine as JEngine
from repro.obs.health import SLOTarget as JTarget
from repro_torch import obs
from repro_torch import resilience as rz
from repro_torch import stream as tstream
from repro_torch.obs import flight
from repro_torch.obs.health import HealthEngine, SLOTarget

V = 96


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jobs):
        o.disable()
        o.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()


def _targets(mod, slo_s):
    return [mod("update", latency_s=slo_s, objective=0.9),
            mod("property", latency_s=4 * slo_s, objective=0.9),
            mod("member", latency_s=slo_s, objective=0.99)]


def _samples(seed, n):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["update", "property", "member", "neighbors"], n)
    lat = rng.lognormal(-5.0, 1.5, n)
    ok = rng.random(n) > 0.05
    return list(zip(kinds.tolist(), lat.tolist(), ok.tolist()))


class _Store:
    """A store sample: only ``_cheap_stats`` is read."""

    def __init__(self, ratio):
        self.ratio = ratio

    def _cheap_stats(self):
        return {"tombstone_ratio": self.ratio, "occupancy": 1.0 - self.ratio}


class _Registry:
    def __init__(self, version, props):
        self.store = types.SimpleNamespace(version=version)
        self.props = props

    def status(self):
        return {k: {"version": v} for k, v in self.props.items()}


@pytest.mark.parametrize("seed,n,window,slo_ms", [
    (0, 40, 256, 10.0), (1, 300, 64, 5.0), (2, 500, 16, 50.0),
    (3, 7, 4, 1e-3)])
def test_reports_equal_for_equal_samples(seed, n, window, slo_ms):
    engines = (HealthEngine(_targets(SLOTarget, slo_ms / 1e3),
                            window=window, store_window=8),
               JEngine(_targets(JTarget, slo_ms / 1e3), window=window,
                       store_window=8))
    reports = ([], [])
    for i, (kind, lat, ok) in enumerate(_samples(seed, n)):
        for eng, out in zip(engines, reports):
            eng.observe_request(kind, lat, ok=ok)
            if i % 13 == 12:
                eng.observe_store(_Store(0.001 * (i % 7)))
                eng.observe_staleness(_Registry(i, {"pagerank": i - 2,
                                                    "wcc": i}))
                out.append(eng.report())
    for eng, out in zip(engines, reports):
        out.append(eng.report())
    assert len(reports[0]) == len(reports[1])
    for a, b in zip(*reports):
        assert a.as_dict() == b.as_dict()
        assert a.render() == b.render()
    assert engines[0].reports == engines[1].reports


def test_shard_imbalance_reads_the_route_gauges():
    eng, jeng = HealthEngine([]), JEngine([])
    assert eng.report().shard_imbalance == {}
    for o in (obs, jobs):
        o.enable()
        o.set_gauge("store.route.ins.imbalance", 1.25)
        o.set_gauge("store.route.del.imbalance", 2.5)
        o.set_gauge("store.other", 9.0)
    r, jr = eng.report(), jeng.report()
    assert r.shard_imbalance == jr.shard_imbalance == {"ins": 1.25,
                                                       "del": 2.5}
    assert obs.get_registry().summary()["gauges"]["health.worst_burn"] == 0


def test_reports_land_in_the_flight_ring():
    for eng, fl in ((HealthEngine([SLOTarget("update", 0.01)]), flight),
                    (JEngine([JTarget("update", 0.01)]), jflight)):
        eng.observe_request("update", 0.02)
        eng.report()
        names = [e["event"] for e in fl.snapshot()]
        assert "health.report" in names and "health.burn_alert" in names


def test_store_and_staleness_feeds_match_on_live_stores():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 64, 300).astype(np.uint32)
    dst = rng.integers(0, 64, 300).astype(np.uint32)
    out = []
    for mod, eng_cls, alg in ((tstream, HealthEngine, "repro_torch"),
                              (jstream, JEngine, "repro")):
        import importlib
        algorithms = importlib.import_module(f"{alg}.algorithms")
        kw = {"device": "cpu"} if mod is tstream else {}
        store = mod.GraphStore.from_edges(64, src, dst, **kw)
        reg = mod.PropertyRegistry(store)
        reg.register(algorithms.pagerank_stream_property(), policy="lazy")
        eng = eng_cls([])
        eng.observe_store(store)
        store.apply(ins_src=[1], ins_dst=[2], del_src=src[:3],
                    del_dst=dst[:3])
        stale = eng.observe_staleness(reg)
        eng.observe_store(store)
        out.append((stale, eng.report().as_dict()))
    assert out[0] == out[1]
    assert out[0][0]["pagerank"] == 1


def test_breaker_burn_trips_and_status_match():
    burns = [0.5, 1.0, 2.5, 3.0, 0.1, 0.2, 4.0, 0.0, 9.0, 0.3]
    script = ["note", "allow", "note", "allow", "note", "shed", "shed",
              "allow", "note", "shed", "allow", "ok", "note", "note",
              "allow", "fail", "note", "note"]
    seen = []
    for mod in (rz, jrz):
        br = mod.CircuitBreaker(threshold=2, cooldown=2, burn_threshold=1.5)
        trace, k = [], 0
        for step in script:
            if step == "note":
                trace.append(br.note_health(
                    types.SimpleNamespace(worst_burn=burns[k % len(burns)])))
                k += 1
            elif step == "allow":
                trace.append(br.allow())
            elif step == "shed":
                br.shed()
            elif step == "ok":
                br.record_success()
            else:
                br.record_failure()
            trace.append(br.status())
        seen.append(trace)
    assert seen[0] == seen[1]
    assert seen[0][-1]["burn_trips"] >= 2
    plain = rz.CircuitBreaker(threshold=3, cooldown=4)
    assert not plain.note_health(types.SimpleNamespace(worst_burn=100.0))
    assert plain.status() == jrz.CircuitBreaker(threshold=3,
                                                cooldown=4).status()
    with pytest.raises(ValueError):
        rz.CircuitBreaker(burn_threshold=0.0)


@pytest.mark.parametrize("every", [1, 2, 3])
def test_pipeline_reports_on_the_reference_cadence(every):
    rng = np.random.default_rng(5)
    src = rng.integers(0, V, 300).astype(np.uint32)
    dst = rng.integers(0, V, 300).astype(np.uint32)
    seen = []
    for mod, eng_cls, tgt, rzm in ((tstream, HealthEngine, SLOTarget, rz),
                                   (jstream, JEngine, JTarget, jrz)):
        kw = {"device": "cpu"} if mod is tstream else {}
        store = mod.GraphStore.from_edges(V, src, dst, **kw)
        eng = eng_cls([tgt("update", 1e-9, objective=0.5)], window=8)
        br = rzm.CircuitBreaker(threshold=99, cooldown=2,
                                burn_threshold=1.5)
        pipe = mod.RequestPipeline(store, None, coalesce=False, breaker=br,
                                   health=eng, health_every=every)
        reqs = []
        for i in range(9):
            reqs.append(mod.UpdateBatch(ins_src=[i, i + 1],
                                        ins_dst=[i + 3, i + 4]))
            if i % 3 == 0:
                reqs.append(mod.MembershipQuery(src=[1, 2], dst=[3, 4]))
        resps = pipe.run(reqs)
        classes = {c.request_class: (c.samples, c.violations)
                   for c in eng.report().classes}
        seen.append((eng.reports, [bool(r.payload.get("shed"))
                                   for r in resps], br.status(), classes,
                     store.version))
    assert seen[0] == seen[1]
    assert seen[0][2]["burn_trips"] >= 1 and any(seen[0][1])


@pytest.mark.parametrize("sharded", [False, True])
def test_store_sample_after_a_failed_apply_matches_reference(sharded):
    """A recoverable failure after the engine ran leaves the pools moved;
    the store sample the health engine reads must then agree with the
    reference's, which reads the device's edge count every time."""
    from repro.resilience import faults as jfaults
    from repro_torch.resilience import faults
    rng = np.random.default_rng(9)
    src = rng.integers(0, V, 300).astype(np.uint32)
    dst = rng.integers(0, V, 300).astype(np.uint32)
    samples = []
    for mod, rzm, fm in ((tstream, rz, faults), (jstream, jrz, jfaults)):
        kw = {"device": "cpu"} if mod is tstream else {}
        store = (mod.ShardedGraphStore.from_edges(V, 4, src, dst, **kw)
                 if sharded else mod.GraphStore.from_edges(V, src, dst, **kw))
        store.apply(del_src=src[5:40], del_dst=dst[5:40])   # tombstones
        store._cheap_stats()
        with pytest.raises(rzm.InjectedOOM):
            with fm.inject(rzm.FaultSpec("apply.pre_close", kind=rzm.OOM,
                                         at=1)):
                store.apply([1, 2, 3], [7, 8, 9], None, src[:5], dst[:5])
        samples.append(store._cheap_stats())
        store.apply([4], [5])
        samples.append(store._cheap_stats())
    assert samples[:2] == samples[2:]
