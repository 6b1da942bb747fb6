"""Port parity for ``obs.instrument`` (``@timed_dispatch``) against the
reference's ``repro.obs.instrument``.

* The reference's ``TestTimedDispatch`` cases: first-call vs steady
  accounting, the disabled pass-through, the re-entrancy guard, the trace
  guard (here under ``torch.jit.trace`` and a patched
  ``torch.compiler.is_compiling``; the reference's own guard never fires
  with the installed JAX, see ROADMAP queue 3), ``pool_bytes`` over
  tensors, graphs, stacked graphs, tuples and dicts.
* ``kernel_summary()`` keys and calls after the same store operations
  equal the reference's: apply, query, compaction and reclamation on both
  store kinds.  One departure, by design: the sharded store's fused epoch
  records as one ``slab_update.update_shards`` dispatch, where the
  reference's jitted epoch calls the engine's raw bodies and records
  nothing.
* The flight-only path (the default) computes no shape signature, records
  no CUDA event and calls no ``torch.cuda.synchronize``.
* Pools are bit-identical with telemetry on and off, for both stores.
"""
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import stream as jstream
from repro_torch import obs
from repro_torch import stream as tstream
from repro_torch.core.slab_graph import FIELDS, empty, stack_graphs
from repro_torch.obs import flight, instrument

V = 96


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jobs):
        o.disable()
        o.reset()
    flight.enable()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()
    flight.enable()


def test_compile_vs_steady_accounting():
    calls = []

    @obs.timed_dispatch("fam")
    def op(x):
        calls.append(1)
        return x + 1

    obs.metrics.enable()
    for i in range(4):
        assert op(torch.tensor(float(i))) == i + 1
    stats = obs.kernel_stats()[("fam", "op", "scalar")]
    assert stats["calls"] == 4 and len(calls) == 4
    assert stats["steady_calls"] == 3        # the first call's own slot
    assert stats["compile_s"] >= 0.0 and stats["steady_s"] >= 0.0
    assert stats["bytes"] == 3 * (4 + 4)     # argument and result leaves
    assert "fam.op[scalar]" in obs.kernel_summary()
    assert obs.get_registry().counters()["kernel.fam.op.calls"] == 4


def test_bytes_fn_lands_in_the_summary_as_the_reference():
    """A caller's ``bytes_fn(args, kwargs, out)`` replaces the leaf sum in
    ``kernel_stats`` and ``kernel_summary``, as in the reference."""
    import jax.numpy as jnp

    def nbytes(args, kwargs, out):
        return 7 * int(args[0].shape[0]) + kwargs.get("extra", 0)

    @obs.timed_dispatch("fam", "op", bytes_fn=nbytes)
    def op(x, extra=0):
        return x + 1

    @jobs.timed_dispatch("fam", "op", bytes_fn=nbytes)
    def jop(x, extra=0):
        return x + 1

    obs.metrics.enable()
    jobs.metrics.enable()
    for i in range(3):
        op(torch.zeros(5), extra=i)
        jop(jnp.zeros(5), extra=i)
    got = obs.kernel_summary()["fam.op[5]"]
    want = jobs.kernel_summary()["fam.op[5]"]
    assert got["bytes"] == want["bytes"] == 2 * 35 + 1 + 2
    assert got["calls"] == want["calls"] == 3
    assert obs.get_registry().counters()["kernel.fam.op.bytes"] == \
        jobs.get_registry().counters()["kernel.fam.op.bytes"]


def test_disabled_is_pass_through():
    @obs.timed_dispatch("fam")
    def op(x):
        return x * 2

    assert op(3) == 6
    assert obs.kernel_stats() == {}
    flight.disable()
    assert op(4) == 8
    assert obs.kernel_stats() == {}


def test_reentrancy_guard_records_only_outermost():
    @obs.timed_dispatch("fam")
    def inner(x):
        return x + 1

    @obs.timed_dispatch("fam")
    def outer(x):
        return inner(x) + 1

    obs.metrics.enable()
    assert outer(torch.zeros(())) == 2
    stats = obs.kernel_stats()
    assert ("fam", "outer", "scalar") in stats
    assert ("fam", "inner", "scalar") not in stats


def test_trace_guard_steps_aside_under_jit_trace():
    @obs.timed_dispatch("fam")
    def op(x):
        return x + 1

    obs.enable()
    seen = []

    def fn(x):
        seen.append(torch.jit.is_tracing())
        return op(x)

    # check_trace=False: the check would run ``fn`` again, untraced
    traced = torch.jit.trace(fn, torch.ones(3), check_trace=False)
    assert seen == [True]
    assert torch.equal(traced(torch.ones(3)), torch.full((3,), 2.0))
    assert obs.kernel_stats() == {}          # no timing of a trace
    assert op(torch.ones(3)).sum() == 6      # and untraced it records
    assert list(obs.kernel_stats()) == [("fam", "op", "3")]


def test_trace_guard_steps_aside_while_compiling(monkeypatch):
    @obs.timed_dispatch("fam")
    def op(x):
        return x + 1

    obs.enable()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert op(torch.ones(())) == 2
    assert obs.kernel_stats() == {}
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    assert op(torch.ones(())) == 2
    assert len(obs.kernel_stats()) == 1


def test_pool_bytes_counts_tensor_leaves():
    tree = {"a": torch.zeros((4, 8)), "b": 3,
            "c": [torch.zeros(2, dtype=torch.int32)]}
    assert obs.pool_bytes(tree) == 4 * 8 * 4 + 2 * 4
    g = empty(10, np.ones(10, np.int32), 32, device="cpu")
    assert obs.pool_bytes(g) == g.nbytes()
    stacked = stack_graphs([g, g, g])
    assert obs.pool_bytes((stacked, None)) == 3 * g.nbytes()
    from repro_torch.distributed.sharded_graph import ShardedSlabGraph
    sg = ShardedSlabGraph(graphs=stacked, n_shards=3, n_vertices_global=30)
    assert obs.pool_bytes({"v": sg}) == 3 * g.nbytes()
    assert instrument._shape_sig((sg, 1)) == "3x32x128"
    assert instrument._shape_sig((g,)) == "32x128"


def _edges(seed=0, n=400):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, n).astype(np.uint32),
            rng.integers(0, V, n).astype(np.uint32))


def _drive_summary(o, mod, **kw):
    src, dst = _edges()
    o.reset()
    o.enable()
    for make in (lambda: mod.GraphStore.from_edges(V, src, dst, **kw),
                 lambda: mod.ShardedGraphStore.from_edges(V, 4, src, dst,
                                                          **kw)):
        store = make()
        store.apply(ins_src=[1, 2, 3], ins_dst=[3, 4, 5], del_src=src[:5],
                    del_dst=dst[:5])
        store.query([1, 2], [3, 4])
        store.maintain(action="compact")
        store.maintain(action="reclaim")
    out = {k: v["calls"] for k, v in o.kernel_summary().items()}
    o.disable()
    return out


def test_kernel_summary_keys_and_calls_match_reference():
    got = _drive_summary(obs, tstream, device="cpu")
    want = _drive_summary(jobs, jstream)
    departure = {k for k in got if k.startswith("slab_update.update_shards")}
    assert departure == {"slab_update.update_shards[4x128x128]"}
    assert got.pop("slab_update.update_shards[4x128x128]") == 1
    assert got == want
    assert {k.split("[")[0] for k in got} >= {
        "slab_update.update_views", "slab_update.query_edges",
        "slab_update.query_shards", "slab_compact.compact",
        "slab_compact.compact_shards", "slab_compact.reclaim_free_slabs",
        "slab_compact.reclaim_shards"}


def test_flight_only_path_never_waits_for_the_device(monkeypatch):
    counts = {"sync": 0, "event": 0, "sig": 0}

    def count(name, ret=None):
        def fn(*a, **k):
            counts[name] += 1
            return ret
        return fn

    monkeypatch.setattr(torch.cuda, "synchronize", count("sync"))
    monkeypatch.setattr(torch.cuda, "Event", count("event"))
    real_sig = instrument._shape_sig
    monkeypatch.setattr(instrument, "_shape_sig",
                        lambda args: (count("sig")(), real_sig(args))[1])
    assert flight.enabled() and not obs.enabled()
    before = flight.stats()["recorded"]
    src, dst = _edges(1)
    for store in (tstream.GraphStore.from_edges(V, src, dst, device="cpu"),
                  tstream.ShardedGraphStore.from_edges(V, 4, src, dst,
                                                       device="cpu")):
        store.apply(ins_src=[1, 2], ins_dst=[3, 4], del_src=src[:4],
                    del_dst=dst[:4])
        store.query([1], [3])
        store.maintain(action="compact")
    assert counts == {"sync": 0, "event": 0, "sig": 0}
    assert obs.kernel_stats() == {}
    names = {e["event"] for e in flight.snapshot()}
    assert {"kernel.slab_update.update_views",
            "kernel.slab_update.update_shards",
            "kernel.slab_compact.compact_shards"} <= names
    assert flight.stats()["recorded"] > before


def _churn(store, seed, epochs=4):
    rng = np.random.default_rng(seed)
    src, dst = _edges()
    ledger = set(zip(src.tolist(), dst.tolist()))
    for _ in range(epochs):
        pool = np.array(sorted(ledger), np.uint32)
        dels = pool[rng.choice(len(pool), min(60, len(pool)),
                               replace=False)]
        ins = rng.integers(0, V, (90, 2)).astype(np.uint32)
        ledger -= {(int(a), int(b)) for a, b in dels}
        ledger |= {(int(a), int(b)) for a, b in ins}
        store.apply(ins[:, 0], ins[:, 1], None, dels[:, 0], dels[:, 1])


def _leaves(store):
    out = []
    for name in sorted(store.views):
        v = store.views[name]
        g = getattr(v, "graphs", v)
        out += [getattr(g, f) for f in FIELDS if getattr(g, f) is not None]
    return out


@pytest.mark.parametrize("kind", ["GraphStore", "ShardedGraphStore"])
def test_pools_identical_with_telemetry_on_and_off(kind):
    from repro_torch.algorithms import pagerank_stream_property
    runs = []
    for mode in ("off", "flight", "all"):
        obs.reset()
        obs.disable()
        flight.enable() if mode != "off" else flight.disable()
        if mode == "all":
            obs.enable()
        src, dst = _edges()
        policy = tstream.MaintenancePolicy(tombstone_ratio=0.1)
        store = (tstream.GraphStore.from_edges(
            V, src, dst, maintenance=policy, device="cpu")
            if kind == "GraphStore" else
            tstream.ShardedGraphStore.from_edges(
                V, 4, src, dst, maintenance=policy, device="cpu"))
        _churn(store, 7)
        assert store.maintenance_count > 0
        reg = tstream.PropertyRegistry(store)
        reg.register(pagerank_stream_property() if kind == "GraphStore"
                     else tstream.sharded_pagerank_property())
        tstream.RequestPipeline(store, reg).run([
            tstream.UpdateBatch(ins_src=[1, 2], ins_dst=[3, 4]),
            tstream.MembershipQuery([1, 2], [3, 4]),
            tstream.PropertyRead("pagerank")])
        runs.append(_leaves(store))
        if mode == "all":
            assert obs.kernel_summary()
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for a, b in zip(runs[0], other):
            assert a.dtype == b.dtype and torch.equal(a, b)
