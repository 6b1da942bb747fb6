"""Port parity for the resilience plane: the write-ahead log, crash
recovery, pool audits, the admission guard, retries, the circuit breaker,
fault injection and the pipeline's overload safety, against the
reference's ``tests/test_resilience.py`` at its sizes.

* The WAL segments the port journals for a weighted and an unweighted
  stream (with rotation) are byte-equal to the reference's, and each
  package's ``read_wal`` reads the other's.
* A kill at each of the five apply sites, then ``recover`` (restore plus
  WAL replay, with the compactions the policy re-derives) and the rest of
  the stream: the port's pools equal the uninterrupted reference twin's,
  leaf for leaf, with the same maintenance counters.
* The audits report the reference's violations, word for word, on clean
  stores and on each planted corruption; ``edge_multiset_hash`` agrees.
* With the whole plane armed and no fault, pools are bit-identical to a
  store running without it.

Everything is integer or compared as bytes: no tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import assert_maintenance_equal, assert_pools_equal

from repro import obs as jobs
from repro import resilience as jrz
from repro import stream as jstream
from repro.resilience import faults as jfaults
from repro_torch import obs
from repro_torch import resilience as rz
from repro_torch.algorithms import pagerank_stream_property
from repro_torch.core.slab_graph import FIELDS, empty
from repro_torch.resilience import faults
from repro_torch.stream import (GraphStore, MaintenancePolicy,
                                PropertyRegistry, PropertySpec,
                                RequestPipeline)
from repro_torch.stream.requests import (MembershipQuery, PropertyRead,
                                         UpdateBatch)


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (faults, jfaults):
        mod.reset()
    for o in (obs, jobs):
        o.disable()
        o.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    for o in (obs, jobs):
        o.disable()
        o.reset()


V = 96
APPLY_SITES = ("apply.admitted", "store.capacity_grow", "apply.post_wal",
               "apply.pre_close", "apply.post_close")
#: compacts every second epoch of ``_stream`` (12 deletes of present edges
#: an epoch against about 400 edges)
RATIO = 0.05


def _seed_edges(seed=3, n=400):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, n).astype(np.uint32),
            rng.integers(0, V, n).astype(np.uint32))


def _stream(seed, n_batches, *, n_ins=60, n_del=12, weighted=False):
    """Churn with fixed shapes: random inserts, and deletes of seed edges
    (present until deleted) so the tombstones trigger compactions."""
    rng = np.random.default_rng(seed)
    src, dst = _seed_edges()
    out = []
    for t in range(n_batches):
        i_s = rng.integers(0, V, n_ins).astype(np.uint32)
        i_d = rng.integers(0, V, n_ins).astype(np.uint32)
        i_w = (rng.uniform(0.5, 3.0, n_ins).astype(np.float32)
               if weighted else None)
        sl = slice(t * n_del, (t + 1) * n_del)
        out.append((i_s, i_d, i_w, src[sl], dst[sl]))
    return out


def _mk(pkg="torch", policy=RATIO):
    src, dst = _seed_edges()
    maint = (MaintenancePolicy if pkg == "torch"
             else jstream.MaintenancePolicy)(tombstone_ratio=policy)
    if pkg == "torch":
        return GraphStore.from_edges(V, src, dst, maintenance=maint,
                                     device="cpu")
    return jstream.GraphStore.from_edges(V, src, dst, maintenance=maint)


def _assert_stores_equal(store, jstore, what=""):
    assert store.version == jstore.version, what
    for name in jstore.views:
        assert_pools_equal(store.views[name], jstore.views[name],
                           f"{what} {name}")


# ============================================================================
# WAL
# ============================================================================

@pytest.mark.parametrize("weighted", [False, True])
def test_wal_segments_byte_equal_to_reference(weighted, tmp_path):
    """Both stores journal the same stream, rotating every two records."""
    src, dst = _seed_edges()
    w = np.ones(len(src), np.float32) if weighted else None
    store = GraphStore.from_edges(V, src, dst, w, device="cpu").attach_wal(
        rz.WriteAheadLog(tmp_path / "port", segment_records=2))
    jstore = jstream.GraphStore.from_edges(V, src, dst, w).attach_wal(
        jrz.WriteAheadLog(tmp_path / "ref", segment_records=2))
    for i_s, i_d, i_w, d_s, d_d in _stream(7, 5, weighted=weighted):
        store.apply(i_s, i_d, i_w, d_s, d_d)
        jstore.apply(i_s, i_d, i_w, d_s, d_d)
    store.wal.close()
    jstore.wal.close()
    port = sorted((tmp_path / "port").glob("wal-*.log"))
    ref = sorted((tmp_path / "ref").glob("wal-*.log"))
    assert [p.name for p in port] == [p.name for p in ref]
    assert len(port) == 3
    for p, r in zip(port, ref):
        assert p.read_bytes() == r.read_bytes(), p.name
    # each package reads the other's log
    for reader, where in ((rz.read_wal, "ref"), (jrz.read_wal, "port")):
        recs, torn = reader(tmp_path / where)
        mine, _ = (jrz.read_wal if reader is rz.read_wal
                   else rz.read_wal)(tmp_path / where)
        assert not torn and [r.version for r in recs] == [1, 2, 3, 4, 5]
        for a, b in zip(recs, mine):
            for f in ("ins_src", "ins_dst", "del_src", "del_dst"):
                assert np.array_equal(getattr(a, f), getattr(b, f))
            assert (a.ins_w is None) == (b.ins_w is None) == (not weighted)
            if weighted:
                assert np.array_equal(a.ins_w, b.ins_w)


def test_wal_roundtrip_and_rotation(tmp_path):
    wal = rz.WriteAheadLog(tmp_path, segment_records=2)
    for v in range(1, 6):
        wal.append(v, [v, v + 1], [v + 2, v + 3],
                   [0.5 * v, 1.5 * v], [v], [v + 9])
    wal.close()
    assert len(list(tmp_path.glob("wal-*.log"))) == 3
    recs, torn = rz.read_wal(tmp_path)
    assert not torn and [r.version for r in recs] == [1, 2, 3, 4, 5]
    assert recs[2].ins_src.tolist() == [3, 4]
    assert recs[2].ins_w.tolist() == [1.5, 4.5]
    assert recs[2].del_dst.tolist() == [12]
    recs, _ = rz.read_wal(tmp_path, after_version=3)
    assert [r.version for r in recs] == [4, 5]


def test_wal_torn_tail_detected_and_prefix_survives(tmp_path):
    with rz.WriteAheadLog(tmp_path) as wal:
        wal.append(1, [1], [2], None, [], [])
        wal.append(2, [3], [4], None, [], [])
    seg = next(tmp_path.glob("wal-*.log"))
    seg.write_bytes(seg.read_bytes()[:-3])
    recs, torn = rz.read_wal(tmp_path)
    assert torn and [r.version for r in recs] == [1]


def test_wal_crc_corruption_stops_replay(tmp_path):
    with rz.WriteAheadLog(tmp_path) as wal:
        wal.append(1, [1], [2], None, [], [])
        wal.append(2, [3], [4], None, [], [])
    seg = next(tmp_path.glob("wal-*.log"))
    data = bytearray(seg.read_bytes())
    data[-1] ^= 0xFF
    seg.write_bytes(bytes(data))
    recs, torn = rz.read_wal(tmp_path)
    assert torn and [r.version for r in recs] == [1]
    recs, torn = jrz.read_wal(tmp_path)
    assert torn and [r.version for r in recs] == [1]


def test_wal_rollback_drops_tail_record(tmp_path):
    wal = rz.WriteAheadLog(tmp_path)
    wal.append(1, [1], [2], None, [], [])
    token = wal.append(2, [3], [4], None, [], [])
    wal.rollback(token)
    wal.append(2, [7], [8], None, [], [])
    wal.close()
    recs, torn = rz.read_wal(tmp_path)
    assert not torn
    assert [(r.version, r.ins_src.tolist()) for r in recs] == \
        [(1, [1]), (2, [7])]


def test_wal_truncate_drops_covered_segments(tmp_path):
    wal = rz.WriteAheadLog(tmp_path, segment_records=2)
    for v in range(1, 7):
        wal.append(v, [v], [v], None, [], [])
    assert wal.truncate(4) == 2
    recs, _ = rz.read_wal(tmp_path)
    assert [r.version for r in recs] == [5, 6]
    wal.close()


def test_wal_reopen_after_crash_continues_segment(tmp_path):
    wal = rz.WriteAheadLog(tmp_path)
    wal.append(1, [1], [2], None, [], [])
    wal._f.close()                             # a kill: no close()
    wal2 = rz.WriteAheadLog(tmp_path)
    wal2.append(1, [5], [6], None, [], [])
    wal2.close()
    recs, torn = rz.read_wal(tmp_path)
    assert not torn and len(recs) == 1


# ============================================================================
# crash recovery against the reference's uninterrupted twin
# ============================================================================

CKPT_AT = 2
CRASH_AT = 5
N_BATCHES = 8


@pytest.mark.parametrize("site", APPLY_SITES)
def test_crash_recovery_matches_reference_twin(site, tmp_path):
    ck, wd = tmp_path / "ck", tmp_path / "wal"
    batches = _stream(23, N_BATCHES)

    twin = _mk("jax")
    vers = []
    for b in batches:
        twin.apply(*b)
        vers.append(twin.version)
    assert twin.maintenance_count >= 2

    store = _mk().attach_wal(rz.WriteAheadLog(wd))
    registry = PropertyRegistry(store)
    registry.register(pagerank_stream_property())
    with pytest.raises(rz.InjectedCrash):
        for t, b in enumerate(batches):
            if t == CKPT_AT:
                store.save(ck, registry=registry)
            if t == CRASH_AT:
                with faults.inject(rz.FaultSpec(site, at=1)):
                    store.apply(*b)
            else:
                store.apply(*b)
    store.wal.close()

    store2, registry2, report = rz.recover(
        ck, wd, specs=[pagerank_stream_property()],
        maintenance=MaintenancePolicy(tombstone_ratio=RATIO),
        wal=rz.WriteAheadLog(wd), device="cpu")
    assert not report.anomalies
    assert report.checkpoint_version == vers[CKPT_AT - 1]
    assert report.crash_reason == f"injected_crash@{site}"
    resume = vers.index(store2.version) + 1
    assert resume == (CRASH_AT if site in APPLY_SITES[:2] else CRASH_AT + 1)
    for b in batches[resume:]:
        store2.apply(*b)
    store2.wal.close()
    _assert_stores_equal(store2, twin, site)
    assert store2._resilience_meta() == twin._resilience_meta()
    assert np.all(np.isfinite(registry2.read("pagerank").numpy()))


def test_failed_apply_rolls_back_wal(tmp_path):
    store = _mk().attach_wal(rz.WriteAheadLog(tmp_path))
    with pytest.raises(rz.InjectedOOM):
        with faults.inject(rz.FaultSpec("apply.pre_close", kind=rz.OOM,
                                        at=1)):
            store.apply([1], [2], None, [], [])
    assert store.version == 0
    recs, _ = rz.read_wal(tmp_path)
    assert recs == []
    store.apply([1], [2], None, [], [])
    assert store.version == 1
    store.wal.close()
    recs, _ = rz.read_wal(tmp_path)
    assert [r.version for r in recs] == [1]
    # the reference's store after the same failure and retry
    jstore = _mk("jax").attach_wal(jrz.WriteAheadLog(tmp_path / "ref"))
    with pytest.raises(jrz.InjectedOOM):
        with jfaults.inject(jrz.FaultSpec("apply.pre_close", kind=jrz.OOM,
                                          at=1)):
            jstore.apply([1], [2], None, [], [])
    jstore.apply([1], [2], None, [], [])
    jstore.wal.close()
    _assert_stores_equal(store, jstore, "after the failed apply")


def test_capacity_grow_retries_transient_ooms():
    store, jstore = _mk(), _mk("jax")
    with faults.inject(rz.FaultSpec("store.capacity_grow", kind=rz.OOM,
                                    at=1)) as plan:
        store.apply([1, 5], [2, 6], None, [], [])
    assert plan.hits["store.capacity_grow"] == 2
    jstore.apply([1, 5], [2, 6], None, [], [])
    _assert_stores_equal(store, jstore, "after a retried grow")
    with pytest.raises(rz.RetryExhausted):
        with faults.inject(rz.FaultSpec("store.capacity_grow", kind=rz.OOM,
                                        every=1, times=0)):
            store.apply([7], [8], None, [], [])
    assert store.version == 1


# ============================================================================
# invariant audits
# ============================================================================

def _violations(report):
    return sorted((v.view, v.check, v.detail, v.count)
                  for v in report.violations)


def test_clean_stores_audit_green():
    report = rz.audit_store(_mk())
    jreport = jrz.audit_store(_mk("jax"))
    assert report.ok and jreport.ok
    assert report.checks_run == jreport.checks_run >= 20


def _corrupt(kind, store, to_dev, mk_empty):
    """Plant one corruption in ``store`` (either package); the audit
    arguments that find it."""
    g = store.views["forward"]
    if kind == "degree":
        deg = np.array(g.degree)
        deg[0] += 1
        store._views["forward"] = dataclasses.replace(
            g, degree=to_dev(deg), n_edges=g.n_edges + 1)
        return dict(cross_view=False)
    if kind == "cycle":
        nxt = np.array(g.next_slab)
        head = int(np.asarray(g.bucket_offset)[0])
        nxt[head] = head                       # a self-loop chain
        store._views["forward"] = dataclasses.replace(g,
                                                      next_slab=to_dev(nxt))
        return dict(views=["forward"], cross_view=False)
    nb = store.views["transpose"].n_buckets
    bc = np.zeros(V, np.int32)
    bc[0] = nb
    store._views["transpose"] = mk_empty(V, bc, nb + 1)
    return dict(views=["forward", "transpose"])


@pytest.mark.parametrize("kind", ["degree", "cycle", "cross_view"])
def test_planted_corruption_reports_reference_violations(kind):
    import jax.numpy as jnp

    from repro.core.slab_graph import empty as jempty
    store, jstore = _mk(), _mk("jax")
    kw = _corrupt(kind, store, torch.from_numpy,
                  lambda *a: empty(*a, weighted=False, device="cpu"))
    jkw = _corrupt(kind, jstore, jnp.asarray,
                   lambda *a: jempty(*a, weighted=False))
    assert kw == jkw
    report = rz.audit_store(store, **kw)
    jreport = jrz.audit_store(jstore, **kw)
    assert not report.ok
    assert _violations(report) == _violations(jreport)
    assert report.checks_run == jreport.checks_run
    want = {"degree": {"degree_mismatch", "n_edges_mismatch"},
            "cycle": {"chain_cycle"}, "cross_view": {"edge_multiset"}}[kind]
    assert want <= {v.check for v in report.violations}


def test_edge_multiset_hash_matches_reference():
    from repro.resilience.invariants import live_edges as jlive
    store, jstore = _mk(), _mk("jax")
    for name in ("forward", "transpose", "symmetric"):
        src, dst = rz.invariants.live_edges(store.views[name])
        js, jd = jlive(jstore.views[name])
        assert rz.edge_multiset_hash(src, dst) == \
            jrz.edge_multiset_hash(js, jd)
        assert rz.edge_multiset_hash(src, dst, swap=True) == \
            jrz.edge_multiset_hash(js, jd, swap=True)
    # ids at and above 2**31, as int32 bit patterns and as uint32 values
    big = np.array([0x80000000, 0xFFFFFFF0], np.uint32)
    gib = big[::-1].copy()
    assert rz.edge_multiset_hash(big, gib) == \
        rz.edge_multiset_hash(torch.from_numpy(big.view(np.int32)),
                              torch.from_numpy(gib.view(np.int32)))
    assert rz.edge_multiset_hash(big, gib) == \
        jrz.edge_multiset_hash(big.astype(np.uint64), gib.astype(np.uint64))


def test_audit_policy_cadence_and_fail_fast():
    store = _mk().attach_audits(rz.AuditPolicy(every=2, fail_fast=True))
    for b in _stream(11, 4):
        store.apply(*b)
    assert len(store.audit_events) == 2
    assert all(e["ok"] for e in store.audit_events)


# ============================================================================
# guard, retries, breaker, faults
# ============================================================================

def test_clean_batch_passes():
    rz.validate_batch([1, 2], [3, 4], [0.5, 1.5], [5], [6], n_vertices=V)


@pytest.mark.parametrize("mode,field", [
    (faults.OOB_SRC, "ins_src"), (faults.NEGATIVE_SRC, "ins_src"),
    (faults.SENTINEL_DST, "ins_dst"), (faults.NAN_WEIGHT, "ins_w")])
def test_corrupt_batches_quarantined_as_in_reference(mode, field):
    src = np.arange(8, dtype=np.uint32)
    dst = np.arange(8, 16, dtype=np.uint32)
    got = faults.corrupt_batch(np.random.default_rng(0), src, dst,
                               mode=mode, n_vertices=V)
    want = jfaults.corrupt_batch(np.random.default_rng(0), src, dst,
                                 mode=mode, n_vertices=V)
    for a, b in zip(got, want):
        assert (a is None and b is None) or np.array_equal(a, b,
                                                           equal_nan=True)
    with pytest.raises(rz.QuarantinedBatch) as ei:
        rz.validate_batch(*got, [], [], n_vertices=V)
    with pytest.raises(jrz.QuarantinedBatch) as ej:
        jrz.validate_batch(*want, [], [], n_vertices=V)
    assert repr(ei.value.reasons) == repr(ej.value.reasons)   # nan
    assert any(r["field"] == field for r in ei.value.reasons)


def test_retry_budget_absorbs_then_exhausts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise rz.InjectedOOM("s", calls["n"])
        return "ok"
    assert rz.run_with_retries(
        flaky, budget=rz.RetryBudget(max_attempts=4), site="s") == "ok"

    def oom():
        raise rz.InjectedOOM("s", 0)
    with pytest.raises(rz.RetryExhausted) as ei:
        rz.run_with_retries(oom, budget=rz.RetryBudget(max_attempts=2),
                            site="s")
    assert ei.value.attempts == 2


def test_breaker_state_machine_matches_reference():
    script = ["allow", "fail", "allow", "fail", "allow", "shed", "allow",
              "shed", "allow", "fail", "shed", "shed", "allow", "ok"]
    seen = []
    for br in (rz.CircuitBreaker(threshold=2, cooldown=2),
               jrz.CircuitBreaker(threshold=2, cooldown=2)):
        trace = []
        for step in script:
            if step == "allow":
                trace.append(br.allow())
            elif step == "fail":
                br.record_failure()
            elif step == "ok":
                br.record_success()
            else:
                br.shed()
            trace.append((br.state, br.failures, br.trips, br.shed_count))
        seen.append(trace)
    assert seen[0] == seen[1]
    assert seen[0][-1] == ("closed", 0, 2, 4)


def test_fault_selectors_and_nesting():
    with faults.inject(rz.FaultSpec("s", kind=rz.LATENCY, every=2,
                                    times=0)) as plan:
        for _ in range(6):
            faults.fault_point("s")
    assert [f["hit"] for f in plan.fired] == [2, 4, 6]
    with faults.inject(rz.FaultSpec("s", kind=rz.OVERFLOW, at=2,
                                    amount=5)) as plan:
        got = [faults.fault_overflow("s") for _ in range(4)]
    assert got == [0, 5, 0, 0] and plan.hits["s"] == 4
    with faults.inject(rz.FaultSpec("s", p=0.5, times=0, kind=rz.LATENCY),
                       seed=9) as plan:
        for _ in range(20):
            faults.fault_point("s")
    with jfaults.inject(jrz.FaultSpec("s", p=0.5, times=0,
                                      kind=jrz.LATENCY), seed=9) as jplan:
        for _ in range(20):
            jfaults.fault_point("s")
    assert plan.fired == jplan.fired and plan.fired
    assert not faults.enabled()
    faults.fault_point("anything")
    with pytest.raises(rz.InjectedCrash):
        with faults.inject(rz.FaultSpec("s", at=1)):
            faults.fault_point("s")
    assert not faults.enabled()
    with faults.inject(rz.FaultSpec("s", at=99)):
        with pytest.raises(RuntimeError):
            with faults.inject(rz.FaultSpec("t", at=1)):
                pass


# ============================================================================
# pipeline overload safety
# ============================================================================

def _count_property():
    return PropertySpec(
        name="n_ins", init=lambda store: 0,
        on_batch=lambda store, state, batch: state + batch.n_inserted,
        refresh=lambda store: int(store.views["forward"].n_edges),
        state_like=lambda n: 0)


def test_unknown_request_and_quarantine_are_structured_errors():
    store = _mk()
    pipe = RequestPipeline(store)
    rs = pipe.run([object(), MembershipQuery([0], [1]),
                   UpdateBatch(ins_src=[1], ins_dst=[2]),
                   UpdateBatch(ins_src=[V + 50], ins_dst=[1])])
    assert rs[0].kind == "error"
    assert rs[0].payload["error"] == "unknown_request"
    assert rs[1].kind == "member"
    # the two updates coalesce, and the bad half quarantines the group
    assert rs[2].kind == rs[3].kind == "error"
    assert rs[3].payload["error"] == "QuarantinedBatch"
    assert rs[3].payload["reasons"][0]["field"] == "ins_src"
    assert store.version == 0
    (r,) = RequestPipeline(store).run([PropertyRead("x")])
    assert r.kind == "error" and r.payload["error"] == "no_registry"


def test_breaker_sheds_then_recovers_and_reads_degrade():
    store = _mk()
    registry = PropertyRegistry(store)
    registry.register(_count_property())
    pipe = RequestPipeline(store, registry, coalesce=False,
                           breaker=rz.CircuitBreaker(threshold=2,
                                                     cooldown=2))
    bad = UpdateBatch(ins_src=[V + 9], ins_dst=[1])
    good = UpdateBatch(ins_src=[4], ins_dst=[5])
    read = PropertyRead("n_ins")
    pipe.run([bad, bad])
    assert pipe.breaker.state == "open"
    r3, rr, r4 = pipe.run([good, read, good])
    assert r3.payload["error"] == "circuit_open" and r3.payload["shed"]
    assert rr.kind == "property" and rr.payload["stale"]
    assert rr.payload["staleness"] == store.version - rr.version
    assert r4.payload["error"] == "circuit_open"
    assert pipe.breaker.shed_count == 2
    (r5,) = pipe.run([good])
    assert r5.kind == "update" and pipe.breaker.state == "closed"
    (r6,) = pipe.run([read])
    assert "stale" not in r6.payload


def test_pipeline_lets_an_injected_crash_unwind():
    pipe = RequestPipeline(_mk(), breaker=rz.CircuitBreaker())
    with pytest.raises(rz.InjectedCrash):
        with faults.inject(rz.FaultSpec("apply.post_wal", at=1)):
            pipe.run([UpdateBatch(ins_src=[1], ins_dst=[2])])
    assert pipe.breaker.failures == 0


# ============================================================================
# no-fault neutrality
# ============================================================================

def test_pools_identical_with_plane_armed(tmp_path):
    def drive(resilient):
        store = _mk()
        if resilient:
            store.attach_wal(rz.WriteAheadLog(tmp_path / "wal"))
            store.attach_audits(rz.AuditPolicy(every=2, fail_fast=True))
            obs.enable()
        registry = PropertyRegistry(store)
        registry.register(pagerank_stream_property())
        for b in _stream(31, 5):
            store.apply(*b)
        registry.read("pagerank")
        if resilient:
            store.wal.close()
            obs.disable()
        return store
    plain, armed = drive(False), drive(True)
    assert plain.maintenance_count >= 1
    for name in plain.views:
        for f in FIELDS:
            a = getattr(plain.views[name], f)
            b = getattr(armed.views[name], f)
            assert (a is None and b is None) or torch.equal(a, b), (name, f)
    assert_maintenance_equal(plain, armed, "armed")
