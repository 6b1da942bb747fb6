"""Port parity for the sharded graph plane, one-device rendering, against
the reference's ``vmap`` path (``repro.distributed.sharded_graph``,
``repro.stream.sharded_store``).

V = 203 with 4 shards (V % S != 0: the last local id space is padded).

* Owner routing: buckets, ``origin`` and the overflow witness are
  bit-equal for random, skewed and undersized-cap batches.
* Sharded insert, delete, query and ``apply_update_sharded``: masks and
  every stacked pool leaf equal after each op, with undersized caps that
  grow.
* ``ShardedGraphStore`` over randomized epochs, weighted and unweighted,
  with an epoch that grows the pools and compactions on the policy's
  trigger: every leaf of every view equal after every epoch.
* WCC and BFS bit-equal; PageRank within 2e-5 (float sums in another
  order); ``compact_shards``, ``reclaim_shards``, ``count_shards`` equal;
  ``triangles_sharded`` equal in int64 (and to the port's unsharded
  ``triangles_static``).
* Checkpoints restore across packages; ``recover(store_cls=
  ShardedGraphStore)`` matches the reference's uninterrupted twin at the
  five apply sites; audits of planted corruptions report the reference's
  violations word for word; the pipeline serves every request kind.

Everything but PageRank is integer or compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_pools_equal, ids, jids, np_of

from repro import resilience as jrz
from repro import stream as jstream
from repro.distributed import sharded_graph as jsg
from repro.kernels import slab_compact as jcompact
from repro.kernels.slab_intersect import ops as jintersect
from repro.resilience import faults as jfaults
from repro_torch import resilience as rz
from repro_torch import stream as tstream
from repro_torch.algorithms import triangles_static
from repro_torch.algorithms.triangle import _sym_bpv
from repro_torch.distributed import collectives
from repro_torch.distributed import sharded_graph as tsg
from repro_torch.kernels import slab_compact as tcompact
from repro_torch.kernels.slab_intersect import ops as tintersect
from repro_torch.resilience import faults

V = 203
S = 4
RATIO = 0.05
PR_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _disarm():
    for m in (faults, jfaults):
        m.reset()
    yield
    for m in (faults, jfaults):
        m.reset()


def rand_edges(rng, n, v=V):
    src = rng.integers(0, v, n).astype(np.uint32)
    dst = rng.integers(0, v, n).astype(np.uint32)
    keep = src != dst
    return src[keep], dst[keep]


def skewed_edges(rng, n, shard=1):
    """Every src owned by one shard: the bucket-overflow adversary."""
    src = (rng.integers(0, V // S, n).astype(np.uint32) * S + shard) % V
    dst = rng.integers(0, V, n).astype(np.uint32)
    return src, dst


def assert_sharded_equal(tg, jg, what=""):
    assert tg.n_shards == jg.n_shards
    assert tg.n_vertices_global == jg.n_vertices_global
    assert_pools_equal(tg.graphs, jg.graphs, what)


def assert_stores_equal(ts, js, what=""):
    assert ts.version == js.version, what
    assert set(ts.views) == set(js.views), what
    for name in js.views:
        assert_sharded_equal(ts.views[name], js.views[name],
                             f"{what} {name}")


# ============================================================================
# routing
# ============================================================================

@pytest.mark.parametrize("kind,n,cap,weighted", [
    ("random", 96, 96, False), ("random", 96, 8, True),
    ("skewed", 64, 64, False), ("skewed", 64, 4, True),
    ("skewed", 64, 0, False), ("padded", 40, 16, False)])
def test_route_buckets_origin_and_witness_bit_equal(kind, n, cap, weighted):
    rng = np.random.default_rng(n + cap)
    src, dst = (skewed_edges(rng, n) if kind == "skewed"
                else rand_edges(rng, n))
    pad = len(src) + 9 if kind == "padded" else len(src)
    w = rng.uniform(0.5, 2.0, pad).astype(np.float32) if weighted else None
    got = tsg.route_edges(ids(src, pad), ids(dst, pad),
                          None if w is None else torch.from_numpy(w),
                          n_shards=S, cap=cap)
    want = jsg.route_edges(jids(src, pad), jids(dst, pad),
                           None if w is None else jnp.asarray(w),
                           n_shards=S, cap=cap)
    for name, a, b in zip(("bsrc", "bdst", "bw", "origin"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert np.array_equal(np_of(a), np_of(b)), name
    assert int(got[4]) == int(want[4])
    assert tsg.routing_cap(src, S) == jsg.routing_cap(src, S)
    assert tsg.max_owner_count(ids(src, pad), S) == \
        jsg.max_owner_count(np.asarray(jids(src, pad)), S)
    assert tsg.routing_cap_blocks(src, S, 8) == \
        jsg.routing_cap_blocks(src, S, 8)


def test_collectives_stacked_forms():
    x = torch.arange(2 * S * 3).reshape(2, S, 3)
    assert torch.equal(collectives.exchange_buckets(x)[1, 0], x[0, 1])
    loc = torch.arange(S * 51).reshape(S, 51)
    glob = collectives.gather_interleaved(loc, V)
    v = torch.arange(V)
    assert torch.equal(glob, loc[v % S, v // S])
    m = torch.zeros(S, 5, dtype=torch.bool)
    m[2, 3] = True
    assert collectives.or_across_shards(m).tolist() == [0, 0, 0, 1, 0]
    assert torch.equal(tsg.owner_of(ids([5, 0xFFFFFFFF]), S),
                       torch.tensor([1, 3], dtype=torch.int32))
    assert np.array_equal(
        np_of(tsg.global_id(tsg.local_id(ids([5, 202]), S),
                            torch.tensor([1, 2]), S)), [5, 202])


# ============================================================================
# sharded ops through the update engine
# ============================================================================

@pytest.mark.parametrize("cap", [None])
def test_sharded_ops_masks_and_pools_equal(cap):
    rng = np.random.default_rng(3)
    tg = tsg.shard_empty(V, S, capacity_slabs_per_shard=128, device="cpu")
    jg = jsg.shard_empty(V, S, capacity_slabs_per_shard=128)
    assert_sharded_equal(tg, jg, "empty")
    present = set()
    for step in range(1):
        s, d = skewed_edges(rng, 40, 1)
        tg, tm = tsg.insert_edges_sharded(tg, ids(s), ids(d), cap=cap)
        jg, jm = jsg.insert_edges_sharded(jg, jids(s), jids(d), cap=cap)
        assert np.array_equal(np_of(tm), np_of(jm))
        assert_sharded_equal(tg, jg, f"insert {step}")
        present |= set(zip(s.tolist(), d.tolist()))
        pool = np.array(sorted(present), np.uint32)
        dels = pool[rng.choice(len(pool), 10, replace=False)]
        dels = np.concatenate([dels, [[7, 9]]]).astype(np.uint32)
        tg, tm = tsg.delete_edges_sharded(tg, ids(dels[:, 0]),
                                          ids(dels[:, 1]), cap=cap)
        jg, jm = jsg.delete_edges_sharded(jg, jids(dels[:, 0]),
                                          jids(dels[:, 1]), cap=cap)
        assert np.array_equal(np_of(tm), np_of(jm))
        assert_sharded_equal(tg, jg, f"delete {step}")
        present -= {(int(a), int(b)) for a, b in dels}
        q = rng.integers(0, V, (40, 2)).astype(np.uint32)
        q[:10] = pool[:10]
        tq = tsg.query_edges_sharded(tg, ids(q[:, 0]), ids(q[:, 1]), cap=cap)
        jq = jsg.query_edges_sharded(jg, jids(q[:, 0]), jids(q[:, 1]),
                                     cap=cap)
        assert np.array_equal(np_of(tq), np_of(jq))
    # one fused mixed epoch
    s, d = rand_edges(rng, 30)
    pool = np.array(sorted(present), np.uint32)[:6]
    tg, ti, td = tsg.apply_update_sharded(
        tg, ids(s), ids(d), None, ids(pool[:, 0]), ids(pool[:, 1]), cap=cap)
    jg, ji, jd = jsg.apply_update_sharded(
        jg, jids(s), jids(d), None, jids(pool[:, 0]), jids(pool[:, 1]),
        cap=cap)
    assert np.array_equal(np_of(ti), np_of(ji))
    assert np.array_equal(np_of(td), np_of(jd))
    assert_sharded_equal(tg, jg, "apply_update_sharded")


def test_empty_batches_are_noops():
    tg = tsg.shard_empty(V, S, capacity_slabs_per_shard=64, device="cpu")
    e = ids([])
    tg, m = tsg.insert_edges_sharded(tg, e, e)
    assert m.shape == (0,)
    assert tsg.query_edges_sharded(tg, e, e).shape == (0,)
    _, im, dm = tsg.apply_update_sharded(tg, e, e, None, e, e)
    assert im is None and dm is None


def test_overflow_storm_grows_the_cap_as_the_reference():
    """Scripted routing-overflow lanes at ``route.resolve``: the cap grows
    (power of two) until it covers the batch, every edge lands, and the
    pools, masks and fired faults are the reference's."""
    rng = np.random.default_rng(4)
    s, d = skewed_edges(rng, 32)
    got = []
    for pkg, mod, m_faults, idf in (("torch", tsg, faults, ids),
                                    ("jax", jsg, jfaults, jids)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        g = mod.shard_empty(V, S, capacity_slabs_per_shard=64, **kw)
        spec = (rz if pkg == "torch" else jrz).FaultSpec(
            "route.resolve", kind="overflow", every=1, times=0, amount=3)
        with m_faults.inject(spec) as plan:
            g, m = mod.insert_edges_sharded(g, idf(s), idf(d), cap=1)
        got.append((g, m, [f["cap"] for f in plan.fired]))
    (tg, tm, tcaps), (jg, jm, jcaps) = got
    assert tcaps == jcaps and tcaps
    assert np.array_equal(np_of(tm), np_of(jm))
    assert int(tm.sum()) == len(set(zip(s.tolist(), d.tolist())))
    assert_sharded_equal(tg, jg, "overflow storm")


def test_shard_map_rendering_raises_naming_the_roadmap(tmp_path):
    """The multi-process rendering is ported (``test_torch_mesh.py``):
    ``dispatch="shard_map"`` without a mesh raises ``ValueError`` as the
    reference's does, a WAL and audits attached or not, and journals
    nothing; the WAL and audits that a mesh store runs since (ROADMAP
    item 4.1) attach, and the audit runs."""
    tg = tsg.shard_empty(V, S, capacity_slabs_per_shard=64, device="cpu")
    with pytest.raises(ValueError, match="place_on_mesh"):
        tsg.wcc_sharded(tg, dispatch="shard_map")
    store = tstream.ShardedGraphStore({"forward": tg}, weighted=False,
                                      dispatch="shard_map")
    with pytest.raises(ValueError, match="place_on_mesh"):
        store.apply([1], [2])
    store.attach_wal(rz.WriteAheadLog(tmp_path))
    store.attach_audits(rz.AuditPolicy(every=1))
    with pytest.raises(ValueError, match="place_on_mesh"):
        store.apply([1], [2])
    assert store.wal.appended == 0
    assert store.audit().ok
    store.wal.close()


# ============================================================================
# the store over randomized epochs (grow, compact), module-scoped
# ============================================================================

def _boot_edges(weighted, seed=0, n=700):
    rng = np.random.default_rng(seed)
    src, dst = rand_edges(rng, n)
    w = rng.uniform(0.5, 3.0, len(src)).astype(np.float32) \
        if weighted else None
    return src, dst, w


def _epochs(seed, weighted, n=2):
    """Churn epochs; epoch 0 inserts a hub burst that grows the pools, and
    the deletes (40 present edges an epoch) compact on the policy's
    trigger at epoch 1."""
    rng = np.random.default_rng(seed)
    src, dst, _ = _boot_edges(weighted)
    present = set(zip(src.tolist(), dst.tolist()))
    out = []
    for e in range(n):
        s, d = rand_edges(rng, 120)
        if e == 0:                       # 600 edges out of shard 1's hubs
            s = np.repeat(np.array([1, 5, 9], np.uint32), 200)
            d = np.resize(rng.permutation(V).astype(np.uint32), 600)
        w = rng.uniform(0.5, 3.0, len(s)).astype(np.float32) \
            if weighted else None
        pool = np.array(sorted(present), np.uint32)
        dels = pool[rng.choice(len(pool), 40, replace=False)]
        present -= {(int(a), int(b)) for a, b in dels}
        present |= set(zip(s.tolist(), d.tolist()))
        out.append((s, d, w, dels[:, 0], dels[:, 1]))
    return out


def _mk(pkg, weighted, ratio=RATIO):
    src, dst, w = _boot_edges(weighted)
    if pkg == "torch":
        return tstream.ShardedGraphStore.from_edges(
            V, S, src, dst, w,
            maintenance=tstream.MaintenancePolicy(tombstone_ratio=ratio),
            device="cpu")
    return jstream.ShardedGraphStore.from_edges(
        V, S, src, dst, w,
        maintenance=jstream.MaintenancePolicy(tombstone_ratio=ratio))


@pytest.fixture(scope="module", params=[False, True],
                ids=["unweighted", "weighted"])
def driven(request):
    """Both packages' stores after the same epochs, with the per-epoch
    comparison results (every leaf, the masks' counts)."""
    weighted = request.param
    ts, js = _mk("torch", weighted), _mk("jax", weighted)
    log, caps = [], []
    cap0 = ts.forward.graphs.keys.shape[1]
    for b in _epochs(11, weighted):
        tb, jb = ts.apply(*b), js.apply(*b)
        log.append((tb.n_inserted, tb.n_deleted, jb.n_inserted, jb.n_deleted,
                    ts.version, js.version))
        caps.append(ts.forward.graphs.keys.shape[1])
        assert_stores_equal(ts, js, f"epoch v{ts.version}")
    return {"ts": ts, "js": js, "log": log, "cap0": cap0, "caps": caps}


def test_store_epochs_equal_leaf_for_leaf(driven):
    ts, js = driven["ts"], driven["js"]
    for ti, td, ji, jd, tv, jv in driven["log"]:
        assert (ti, td, tv) == (ji, jd, jv)
    assert max(driven["caps"]) > driven["cap0"]               # it grew
    assert ts.maintenance_count == js.maintenance_count >= 1   # compacted
    assert ts._resilience_meta() == js._resilience_meta()
    assert [{k: v for k, v in e.items() if k != "duration_s"}
            for e in ts.maintenance_events] == \
        [{k: v for k, v in e.items() if k != "duration_s"}
         for e in js.maintenance_events]
    assert np.array_equal(np_of(ts.out_degree), np_of(js.out_degree))
    assert np.array_equal(np_of(ts.in_degree), np_of(js.in_degree))
    assert ts.n_edges == js.n_edges
    assert ts.sweep_rows("transpose") == js.sweep_rows("transpose")
    q = np.random.default_rng(2).integers(0, V, (64, 2)).astype(np.uint32)
    assert np.array_equal(ts.query(q[:, 0], q[:, 1]),
                          js.query(q[:, 0], q[:, 1]))
    assert ts.pool_stats()["live_lanes"] == js.pool_stats()["live_lanes"]


def test_analytics_equal_reference(driven):
    ts, js = driven["ts"], driven["js"]
    if ts.weighted:
        pytest.skip("BFS levels need an unweighted store")
    t_lab, t_it = tsg.wcc_sharded(ts.symmetric,
                                  rows=ts.sweep_rows("symmetric"))
    j_lab, j_it = jsg.wcc_sharded(js.symmetric,
                                  rows=js.sweep_rows("symmetric"))
    assert np.array_equal(np_of(t_lab), np_of(j_lab)) and t_it == int(j_it)
    t_d, t_it = tsg.bfs_sharded(ts.transpose, src=0)
    j_d, j_it = jsg.bfs_sharded(js.transpose, src=0)
    assert np.array_equal(np_of(t_d), np_of(j_d)) and t_it == int(j_it)
    t_pr, _ = tsg.pagerank_sharded(ts.transpose, ts.out_degree,
                                   rows=ts.sweep_rows("transpose"))
    j_pr, _ = jsg.pagerank_sharded(js.transpose, js.out_degree,
                                   rows=js.sweep_rows("transpose"))
    np.testing.assert_allclose(np_of(t_pr), np_of(j_pr), atol=PR_ATOL,
                               rtol=0)


def test_analytics_impl_equal_reference(driven):
    """``impl`` reaches each shard's sweep: the plain sweep ("torch")
    against the reference's ``impl="ref"``; "cuda" on CPU tensors
    raises."""
    ts, js = driven["ts"], driven["js"]
    if ts.weighted:
        pytest.skip("BFS levels need an unweighted store")
    t_lab, t_it = tsg.wcc_sharded(ts.symmetric, impl="torch")
    j_lab, j_it = jsg.wcc_sharded(js.symmetric, impl="ref")
    assert np.array_equal(np_of(t_lab), np_of(j_lab)) and t_it == int(j_it)
    t_d, t_it = tsg.bfs_sharded(ts.transpose, src=3, impl="torch")
    j_d, j_it = jsg.bfs_sharded(js.transpose, src=3, impl="ref")
    assert np.array_equal(np_of(t_d), np_of(j_d)) and t_it == int(j_it)
    t_pr, t_it = tsg.pagerank_sharded(ts.transpose, ts.out_degree,
                                      impl="torch")
    j_pr, j_it = jsg.pagerank_sharded(js.transpose, js.out_degree,
                                      impl="ref")
    np.testing.assert_allclose(np_of(t_pr), np_of(j_pr), atol=PR_ATOL,
                               rtol=0)
    assert t_it == int(j_it)
    for run in (lambda: tsg.wcc_sharded(ts.symmetric, impl="cuda"),
                lambda: tsg.bfs_sharded(ts.transpose, src=0, impl="cuda"),
                lambda: tsg.pagerank_sharded(ts.transpose, ts.out_degree,
                                             impl="cuda")):
        with pytest.raises(ValueError, match="does not match"):
            run()


def test_triangles_cap_checked_never_truncates(driven):
    """The reference's ``cap`` bounds a shard's compacted edge set; the
    port sizes its buffers from the data, counts the same at or above the
    worst shard's live lanes, and raises under it."""
    ts, js = driven["ts"], driven["js"]
    live = max(int(tsg.pool_edges(tsg.shard_view(ts.symmetric.graphs, k))
                   .valid.sum()) for k in range(S))
    want = int(jsg.triangles_sharded(js.symmetric))
    assert int(tsg.triangles_sharded(ts.symmetric, cap=live)) == want
    assert int(jsg.triangles_sharded(js.symmetric, cap=live)) == want
    with pytest.raises(ValueError, match="truncate"):
        tsg.triangles_sharded(ts.symmetric, cap=live - 1)


def test_triangles_sharded_total_is_int64(driven, monkeypatch):
    """Each of the S x S Count() calls stubbed to 2**30: the shares sum
    past 2**31 without wrapping, where the reference's int32 sum would (a
    served RMAT scale-20 graph's 6T is 2,533,482,588)."""
    ts = driven["ts"]
    calls = []

    def stub(g1, g2, us, vs, emask, **kw):
        calls.append(int(emask.sum()))
        return torch.tensor(2 ** 30, dtype=torch.int64)

    monkeypatch.setattr(tsg, "count_edges_local", stub)
    got = tsg.triangles_sharded(ts.symmetric)
    live = sum(int(tsg.pool_edges(tsg.shard_view(ts.symmetric.graphs, k))
                   .valid.sum()) for k in range(S))
    assert len(calls) == S * S and sum(calls) == live
    assert got.dtype == torch.int64
    assert int(got) == (S * S * 2 ** 30) // 6


def test_triangles_and_count_shards_equal(driven):
    ts, js = driven["ts"], driven["js"]
    if ts.weighted:
        pytest.skip("the count reads no weight: the unweighted case holds it")
    got = tsg.triangles_sharded(ts.symmetric)
    assert got.dtype == torch.int64
    assert int(got) == int(jsg.triangles_sharded(js.symmetric))
    per = tsg.triangle_counts_sharded(ts.symmetric.graphs)
    # the per-shard shares, through count_shards on the rotated stacks
    g = ts.symmetric.graphs
    es, ed, m = [], [], []
    for k in range(S):
        s, d = tsg._shard_edges(tsg.shard_slice(ts.symmetric, k))
        es.append(s), ed.append(d)
    n = max(len(x) for x in es)
    pad = [torch.cat([x, x.new_zeros(n - len(x))]) for x in es]
    padd = [torch.cat([x, x.new_zeros(n - len(x))]) for x in ed]
    emask = torch.stack([torch.arange(n) < len(x) for x in es])
    us = tsg.local_id(torch.stack(padd), S)
    vs = torch.stack(pad)
    owner = tsg.owner_of(torch.stack(padd), S)
    # rotation 1 (G1 = the next shard) against the reference's count_shards
    jg = js.symmetric.graphs
    for r in (1,):
        rolled = dataclasses.replace(g, **{
            f: None if getattr(g, f) is None
            else torch.roll(getattr(g, f), -r, 0)
            for f in ("keys", "weights", "next_slab", "slab_vertex",
                      "bucket_offset", "bucket_count", "bucket_vertex",
                      "tail_slab", "tail_fill", "upd_flag", "upd_slab",
                      "upd_lane", "next_free", "epoch_next_free",
                      "free_list", "free_top", "slab_new", "degree",
                      "n_edges")})
        mr = emask & (owner == (torch.arange(S)[:, None] + r) % S)
        part = tintersect.count_shards(rolled, g, us, vs, mr, max_bpv=1)
        jrolled = jax.tree.map(lambda x: jnp.roll(x, -r, axis=0), jg)
        jpart = jintersect.count_shards(
            jrolled, jg, jnp.asarray(np_of(us).view(np.uint32)),
            jnp.asarray(np_of(vs).view(np.uint32)), jnp.asarray(mr.numpy()),
            max_bpv=1)
        assert part.tolist() == np.asarray(jpart).tolist()
    assert int(per.sum()) // 6 == int(got)
    # and the unsharded union's static count
    pairs = _live_pairs(ts, "forward")
    store = tstream.GraphStore.from_edges(
        V, pairs[:, 0], pairs[:, 1], hashing=True, with_transpose=False,
        device="cpu")
    assert int(triangles_static(store.symmetric,
                                max_bpv=_sym_bpv(store.symmetric))) == \
        int(got)


def _live_pairs(store, view):
    from repro_torch.resilience.invariants import _store_edges
    s, d = _store_edges(store, view)
    return np.stack([s, d], axis=1).astype(np.uint32)


def test_compact_and_reclaim_shards_equal(driven):
    ts, js = driven["ts"], driven["js"]
    # on copies: the stores stay as the other tests read them
    t_graphs = dataclasses.replace(ts.forward.graphs, **{
        f: None if getattr(ts.forward.graphs, f) is None
        else getattr(ts.forward.graphs, f).clone()
        for f in ("keys", "weights", "next_slab", "slab_vertex",
                  "bucket_offset", "bucket_count", "bucket_vertex",
                  "tail_slab", "tail_fill", "upd_flag", "upd_slab",
                  "upd_lane", "next_free", "epoch_next_free", "free_list",
                  "free_top", "slab_new", "degree", "n_edges")})
    j_graphs = js.forward.graphs
    t2, trep = tcompact.compact_shards(t_graphs, slack_slabs=16)
    j2, jrep = jcompact.compact_shards(j_graphs, slack_slabs=16)
    assert_pools_equal(t2, j2, "compact_shards")
    assert np.array_equal(np_of(trep.perm), np_of(jrep.perm))
    for f in ("live_lanes", "live_slabs", "old_capacity", "new_capacity",
              "old_next_free", "new_next_free"):
        assert getattr(trep, f) == getattr(jrep, f), f
    t3, tn = tcompact.reclaim_shards(t2)
    j3, jn = jcompact.reclaim_shards(j2)
    assert tn == jn
    assert_pools_equal(t3, j3, "reclaim_shards")


# ============================================================================
# properties, pipeline, checkpoints, recovery, audits
# ============================================================================

def sharded_store_of(mod):
    """The package's sharded-store module (the reference exports its
    triangle property from there only)."""
    import importlib
    return importlib.import_module(mod.__name__ + ".sharded_store")


def test_properties_and_pipeline_match_reference():
    rng = np.random.default_rng(21)
    src, dst = rand_edges(rng, 500)
    stores = []
    for pkg, mod in (("torch", tstream), ("jax", jstream)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        store = mod.ShardedGraphStore.from_edges(V, S, src, dst, **kw)
        reg = mod.PropertyRegistry(store)
        reg.register(mod.sharded_pagerank_property())
        reg.register(mod.sharded_bfs_property(0))
        reg.register(mod.sharded_wcc_property())
        reg.register(sharded_store_of(mod).sharded_triangle_property())
        pipe = mod.RequestPipeline(store, reg)
        s, d = rand_edges(np.random.default_rng(5), 40)
        resps = pipe.run([
            mod.UpdateBatch(ins_src=s, ins_dst=d, del_src=src[:9],
                            del_dst=dst[:9]),
            mod.PropertyRead("bfs_0"), mod.PropertyRead("wcc"),
            mod.PropertyRead("pagerank"),
            mod.MembershipQuery(src=src[:30], dst=dst[:30]),
            mod.NeighborsQuery(vertices=[0, 1, 2, 5, 202]),
            mod.UpdateBatch(ins_src=[2], ins_dst=[4]),
            mod.PropertyRead("wcc"), mod.PropertyRead("triangles")])
        stores.append((store, resps))
    (ts, tr), (js, jr) = stores
    assert_stores_equal(ts, js, "pipeline")
    assert [r.kind for r in tr] == [r.kind for r in jr]
    assert [r.version for r in tr] == [r.version for r in jr]
    for i in (1, 2, 7):
        assert np.array_equal(np_of(tr[i].payload["value"]),
                              np_of(jr[i].payload["value"])), i
    np.testing.assert_allclose(np_of(tr[3].payload["value"]),
                               np_of(jr[3].payload["value"]), atol=PR_ATOL,
                               rtol=0)
    assert np.array_equal(tr[4].payload["found"], jr[4].payload["found"])
    assert tr[8].payload["value"].dtype == torch.int64
    assert int(tr[8].payload["value"]) == int(jr[8].payload["value"]) > 0
    for key in ("count", "overflow"):
        assert tr[5].payload[key] == jr[5].payload[key]
    n = tr[5].payload["count"]
    assert np.array_equal(tr[5].payload["src"].view(np.uint32)[:n],
                          jr[5].payload["src"][:n])
    assert np.array_equal(tr[5].payload["dst"].view(np.uint32)[:n],
                          jr[5].payload["dst"][:n])


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_checkpoint_restores_across_packages(direction, tmp_path):
    rng = np.random.default_rng(8)
    src, dst = rand_edges(rng, 400)
    out = {}
    for pkg, mod in (("torch", tstream), ("jax", jstream)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        store = mod.ShardedGraphStore.from_edges(
            V, S, src, dst,
            maintenance=mod.MaintenancePolicy(tombstone_ratio=RATIO), **kw)
        reg = mod.PropertyRegistry(store)
        reg.register(mod.sharded_wcc_property())
        reg.register(mod.sharded_bfs_property(0))
        for b in _epochs(3, False)[:2]:
            store.apply(*b)
        reg.read("wcc"), reg.read("bfs_0")
        out[pkg] = (store, reg, mod)
    src_pkg, dst_pkg = (("torch", "jax") if direction == "port_to_ref"
                        else ("jax", "torch"))
    store, reg, _ = out[src_pkg]
    store.save(tmp_path, registry=reg)
    mod = out[dst_pkg][2]
    kw = {"device": "cpu"} if dst_pkg == "torch" else {}
    back, breg = mod.ShardedGraphStore.restore(
        tmp_path, specs=[mod.sharded_wcc_property(),
                         mod.sharded_bfs_property(0)], **kw)
    ts, js = (back, store) if dst_pkg == "torch" else (store, back)
    assert_stores_equal(ts, js, direction)
    assert back._resilience_meta() == store._resilience_meta()
    for name in ("wcc", "bfs_0"):
        assert np.array_equal(np_of(breg.peek(name)[0]),
                              np_of(reg.peek(name)[0])), name


APPLY_SITES = ("apply.admitted", "store.capacity_grow", "apply.post_wal",
               "apply.pre_close", "apply.post_close")
CKPT_AT, CRASH_AT, N_BATCHES = 2, 5, 8


def _crash_stream():
    """The reference's crash-recovery stream (tests/test_resilience.py):
    V = 96, fixed shapes, seed 23, boot edges from seed 3."""
    rng = np.random.default_rng(23)
    out = []
    for _ in range(N_BATCHES):
        out.append(tuple(rng.integers(0, 96, n).astype(np.uint32)
                         for n in (60, 60, 12, 12)))
    return out


def _crash_store(mod, **kw):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 96, 400).astype(np.uint32)
    dst = rng.integers(0, 96, 400).astype(np.uint32)
    return mod.ShardedGraphStore.from_edges(
        96, 4, src, dst,
        maintenance=mod.MaintenancePolicy(tombstone_ratio=0.15), **kw)


@pytest.fixture(scope="module")
def crash_twin():
    twin = _crash_store(jstream)
    vers = []
    for i_s, i_d, d_s, d_d in _crash_stream():
        twin.apply(i_s, i_d, None, d_s, d_d)
        vers.append(twin.version)
    return twin, vers


@pytest.mark.parametrize("site", APPLY_SITES)
def test_recover_matches_reference_twin(site, crash_twin, tmp_path):
    twin, vers = crash_twin
    batches = _crash_stream()
    ck, wd = tmp_path / "ck", tmp_path / "wal"
    store = _crash_store(tstream, device="cpu").attach_wal(
        rz.WriteAheadLog(wd))
    registry = tstream.PropertyRegistry(store)
    registry.register(tstream.sharded_pagerank_property())
    with pytest.raises(rz.InjectedCrash):
        for t, (i_s, i_d, d_s, d_d) in enumerate(batches):
            if t == CKPT_AT:
                store.save(ck, registry=registry)
            if t == CRASH_AT:
                with faults.inject(rz.FaultSpec(site, at=1)):
                    store.apply(i_s, i_d, None, d_s, d_d)
            else:
                store.apply(i_s, i_d, None, d_s, d_d)
    store.wal.close()
    store2, registry2, report = rz.recover(
        ck, wd, store_cls=tstream.ShardedGraphStore,
        specs=[tstream.sharded_pagerank_property()],
        maintenance=tstream.MaintenancePolicy(tombstone_ratio=0.15),
        wal=rz.WriteAheadLog(wd), device="cpu")
    assert not report.anomalies
    assert report.checkpoint_version == vers[CKPT_AT - 1]
    assert report.crash_reason == f"injected_crash@{site}"
    resume = vers.index(store2.version) + 1
    assert resume == (CRASH_AT if site in APPLY_SITES[:2] else CRASH_AT + 1)
    for i_s, i_d, d_s, d_d in batches[resume:]:
        store2.apply(i_s, i_d, None, d_s, d_d)
    store2.wal.close()
    assert_stores_equal(store2, twin, site)
    assert store2._resilience_meta() == twin._resilience_meta()
    assert np.all(np.isfinite(np_of(registry2.read("pagerank"))))


def _violations(report):
    return sorted((v.view, v.check, v.detail, v.count)
                  for v in report.violations)


def _plant(kind, store, to_dev):
    """One corruption in shard 2 of ``store`` (either package); the audit
    arguments that find it."""
    sg = store.views["forward"]
    g = sg.graphs
    if kind == "degree":
        deg = np.array(g.degree)
        deg[2, 0] += 1
        graphs = dataclasses.replace(g, degree=to_dev(deg))
        kw = dict(cross_view=False)
    elif kind == "cycle":
        nxt = np.array(g.next_slab)
        nxt[2, 3] = 3                         # a self-loop chain
        graphs = dataclasses.replace(g, next_slab=to_dev(nxt))
        kw = dict(views=["forward"], cross_view=False)
    else:
        keys = np.array(g.keys)
        keys[1, 0, 0] = np.asarray(keys[1, 0, 0]).dtype.type(7)
        graphs = dataclasses.replace(g, keys=to_dev(keys))
        kw = dict(views=["forward", "transpose", "symmetric"])
    store._views["forward"] = dataclasses.replace(sg, graphs=graphs)
    return kw


@pytest.mark.parametrize("kind", ["degree", "cycle", "cross_view"])
def test_planted_corruption_audits_equal(kind):
    rng = np.random.default_rng(6)
    src, dst = rand_edges(rng, 300)
    ts = tstream.ShardedGraphStore.from_edges(V, S, src, dst, device="cpu")
    js = jstream.ShardedGraphStore.from_edges(V, S, src, dst)
    assert rz.audit_store(ts).ok and jrz.audit_store(js).ok
    kw = _plant(kind, ts, torch.from_numpy)
    assert kw == _plant(kind, js, jnp.asarray)
    report, jreport = rz.audit_store(ts, **kw), jrz.audit_store(js, **kw)
    assert not report.ok
    assert _violations(report) == _violations(jreport)
    assert report.checks_run == jreport.checks_run
