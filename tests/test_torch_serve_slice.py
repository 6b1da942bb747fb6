"""Port parity for the serving loop as a whole: the same request stream
through the JAX reference (GraphStore + PropertyRegistry + RequestPipeline,
PageRank on its slab-sweep engine) and through the port, on the CPU.

After every epoch both views are leaf-identical, the BFS tree is
bit-identical and membership answers are equal.  With a maintenance policy
that compacts mid-stream and WCC served as a fifth request kind, the pools
(maintenance epochs included), versions, component labels and maintenance
counters are identical after every request.  PageRank is held to
``PR_ATOL``: the port sums each row's lanes in another order than XLA, and
the convergence test (L1 change > 1e-5) may then stop one iteration apart,
which moves no entry by more than the L1 margin itself.
"""
import numpy as np
import pytest
import torch

from _torch_port import (assert_maintenance_equal, assert_pools_equal,
                         assert_vectors_equal, np_of)

from repro.algorithms import bfs_stream_property as jax_bfs_prop
from repro.algorithms import pagerank_stream_property as jax_pr_prop
from repro.algorithms import wcc_stream_property as jax_wcc_prop
from repro.data.synth import rmat_edges
from repro.launch import serve as jax_serve
from repro import stream as jstream
from repro_torch import stream as tstream
from repro_torch.algorithms import (bfs_stream_property,
                                    pagerank_stream_property,
                                    wcc_stream_property)
from repro_torch.launch import serve as torch_serve

PR_ATOL = 2e-5
PROPS = ["pagerank", "bfs_0"]


def _requests(mod, V, edges, seed, n, batch, props=PROPS, **kw):
    return list(mod.build_requests(V, edges, np.random.default_rng(seed),
                                   n_requests=n, batch=batch,
                                   delete_frac=0.25, prop_names=props, **kw))


def _same_request(a, b):
    for f in ("ins_src", "ins_dst", "del_src", "del_dst", "src", "dst",
              "name"):
        if hasattr(a, f):
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, str):
                assert x == y
            else:
                assert np.array_equal(np.asarray(x, np.int64),
                                      np.asarray(y, np.int64)), f


def test_build_requests_draws_the_reference_stream():
    V = 300
    src, dst = rmat_edges(V, 3000, seed=1)
    src, dst, _ = jstream.dedup_pairs(src, dst)
    want = _requests(jax_serve, V, (src, dst), 1, 16, 128)
    ledger = torch_serve.EdgeLedger(src, dst)
    got = _requests(torch_serve, V, (src, dst), 1, 16, 128, ledger=ledger)
    assert [k for k, _ in got] == [k for k, _ in want]
    present = set(zip(src.tolist(), dst.tolist()))
    for (_, a), (_, b) in zip(got, want):
        _same_request(a, b)
        if hasattr(b, "ins_src"):
            present -= set(zip(np.asarray(b.del_src, np.int64).tolist(),
                               np.asarray(b.del_dst, np.int64).tolist()))
            present |= set(zip(b.ins_src.tolist(), b.ins_dst.tolist()))
    assert set(map(tuple, torch_serve.EdgeLedger.pairs(ledger.keys)
                   .astype(np.int64).tolist())) == present


@pytest.mark.parametrize("policy", ["lazy", "eager"])
def test_serve_loop_matches_reference(policy):
    V, batch, cycles = 256, 64, 6
    src, dst = rmat_edges(V, 2000, seed=0)
    src, dst, _ = jstream.dedup_pairs(src, dst)
    n = cycles * (len(PROPS) + 2)
    slack = n * batch // 64 + 512
    cap = len(src) + n * batch + 4096

    js = jstream.GraphStore.from_edges(V, src, dst, hashing=False,
                                       with_symmetric=False,
                                       slack_slabs=slack)
    jreg = jstream.PropertyRegistry(js)
    jreg.register(jax_pr_prop(contrib_impl="sweep"), policy=policy)
    jreg.register(jax_bfs_prop(0, edge_capacity=cap), policy=policy)
    jpipe = jstream.RequestPipeline(js, jreg)

    ts = tstream.GraphStore.from_edges(V, src, dst, hashing=False,
                                       with_symmetric=False,
                                       slack_slabs=slack, device="cpu")
    treg = tstream.PropertyRegistry(ts)
    treg.register(pagerank_stream_property(), policy=policy)
    treg.register(bfs_stream_property(0, edge_capacity=cap), policy=policy)
    tpipe = tstream.RequestPipeline(ts, treg)

    jreqs = _requests(jax_serve, V, (src, dst), 0, n, batch)
    treqs = _requests(torch_serve, V, (src, dst), 0, n, batch)
    for (kind, jr), (_, tr) in zip(jreqs, treqs):
        _same_request(tr, jr)
        jresp, = jpipe.run([jr])
        tresp, = tpipe.run([tr])
        assert (tresp.kind, tresp.version) == (jresp.kind, jresp.version)
        if kind == "update":
            assert tresp.payload == jresp.payload
            for view in ("forward", "transpose"):
                assert_pools_equal(ts.views[view], js.views[view],
                                   f"{view} v{ts.version}")
        elif kind == "member":
            assert np.array_equal(tresp.payload["found"],
                                  jresp.payload["found"])
        elif kind == "read:bfs_0":
            for a, b in zip(tresp.payload["value"], jresp.payload["value"]):
                assert np.array_equal(np_of(a), np_of(b))
        else:
            np.testing.assert_allclose(np_of(tresp.payload["value"]),
                                       np_of(jresp.payload["value"]),
                                       rtol=0, atol=PR_ATOL)


@pytest.mark.parametrize("policy", ["lazy", "eager"])
def test_maintained_serve_loop_matches_reference(policy):
    """The five-kind cycle with a policy that compacts every second update
    (16 tombstones per update against about 1,500 edges)."""
    V, batch, cycles = 256, 64, 4
    props = PROPS + ["wcc"]
    src, dst = rmat_edges(V, 2000, seed=0)
    src, dst, _ = jstream.dedup_pairs(src, dst)
    n = cycles * (len(props) + 2)
    slack = n * batch // 64 + 512
    cap = len(src) + n * batch + 4096
    ratio = 0.015

    js = jstream.GraphStore.from_edges(
        V, src, dst, hashing=False, with_symmetric=False, slack_slabs=slack,
        maintenance=jstream.MaintenancePolicy(tombstone_ratio=ratio))
    jreg = jstream.PropertyRegistry(js)
    jreg.register(jax_pr_prop(contrib_impl="sweep"), policy=policy)
    jreg.register(jax_bfs_prop(0, edge_capacity=cap), policy=policy)
    jreg.register(jax_wcc_prop(), policy=policy)
    jpipe = jstream.RequestPipeline(js, jreg)

    ts = tstream.GraphStore.from_edges(
        V, src, dst, hashing=False, with_symmetric=False, slack_slabs=slack,
        maintenance=tstream.MaintenancePolicy(tombstone_ratio=ratio),
        device="cpu")
    treg = tstream.PropertyRegistry(ts)
    treg.register(pagerank_stream_property(), policy=policy)
    treg.register(bfs_stream_property(0, edge_capacity=cap), policy=policy)
    treg.register(wcc_stream_property(), policy=policy)
    tpipe = tstream.RequestPipeline(ts, treg)

    jreqs = _requests(jax_serve, V, (src, dst), 0, n, batch, props)
    treqs = _requests(torch_serve, V, (src, dst), 0, n, batch, props)
    for i, ((kind, jr), (_, tr)) in enumerate(zip(jreqs, treqs)):
        _same_request(tr, jr)
        jresp, = jpipe.run([jr])
        tresp, = tpipe.run([tr])
        what = f"request {i} ({kind})"
        assert (tresp.kind, tresp.version) == (jresp.kind, jresp.version)
        for view in ("forward", "transpose"):
            assert_pools_equal(ts.views[view], js.views[view],
                               f"{what}: {view}")
        assert_maintenance_equal(ts, js, what)
        # the WCC entry as it stands, without a catch-up
        state, version = jreg.peek("wcc")
        entry = treg._entries["wcc"]
        assert entry.version == version, what
        assert_vectors_equal(entry.state, state, f"{what}: wcc")
        if kind == "update":
            assert tresp.payload == jresp.payload
        elif kind == "read:wcc":
            assert_vectors_equal(tresp.payload["value"],
                                 jresp.payload["value"], what)
        elif kind == "read:bfs_0":
            for a, b in zip(tresp.payload["value"], jresp.payload["value"]):
                assert np.array_equal(np_of(a), np_of(b))
        elif kind == "read:pagerank":
            np.testing.assert_allclose(np_of(tresp.payload["value"]),
                                       np_of(jresp.payload["value"]),
                                       rtol=0, atol=PR_ATOL)
        else:
            assert np.array_equal(tresp.payload["found"],
                                  jresp.payload["found"])
    assert ts.maintenance_count == cycles // 2


def test_describe_and_store_accessors_match_reference():
    """``describe(resp, n_vertices)`` prints the reference's line for each
    response kind; ``GraphStore.in_degree`` and ``max_bpv`` equal the
    reference's bit for bit (and ``in_degree`` raises its error without a
    transpose); ``VersionedStoreBase.pool_stats`` is the protocol's
    hook in both."""
    V = 200
    src, dst = rmat_edges(V, 1500, seed=3)
    # a hub of 190 out-edges: more than one bucket when hashed
    src = np.concatenate([src, np.full(190, 7, np.uint32)])
    dst = np.concatenate([dst, np.arange(10, 200, dtype=np.uint32)])
    src, dst, _ = jstream.dedup_pairs(src, dst)
    js = jstream.GraphStore.from_edges(V, src, dst, hashing=True,
                                       slack_slabs=256)
    ts = tstream.GraphStore.from_edges(V, src, dst, hashing=True,
                                       slack_slabs=256, device="cpu")
    assert ts.max_bpv == js.max_bpv > 1
    assert np.array_equal(np_of(ts.in_degree), np_of(js.in_degree))
    for mod in (jstream, tstream):
        lone = mod.GraphStore.from_edges(V, src, dst, with_transpose=False,
                                         **({"device": "cpu"}
                                            if mod is tstream else {}))
        with pytest.raises(ValueError, match="with_transpose=True"):
            lone.in_degree
        with pytest.raises(NotImplementedError):
            mod.store.VersionedStoreBase().pool_stats()

    jreg, treg = jstream.PropertyRegistry(js), tstream.PropertyRegistry(ts)
    jreg.register(jax_pr_prop(contrib_impl="sweep"))
    jreg.register(jax_bfs_prop(0, edge_capacity=4096))
    jreg.register(jax_wcc_prop())
    treg.register(pagerank_stream_property())
    treg.register(bfs_stream_property(0, edge_capacity=4096))
    treg.register(wcc_stream_property())
    props = ["pagerank", "bfs_0", "wcc"]
    jresps = jstream.RequestPipeline(js, jreg).run(
        [r for _, r in _requests(jax_serve, V, (src, dst), 5, 10, 64,
                                 props=props)])
    tresps = tstream.RequestPipeline(ts, treg).run(
        [r for _, r in _requests(torch_serve, V, (src, dst), 5, 10, 64,
                                 props=props)])
    kinds = set()
    for tr, jr in zip(tresps, jresps):
        got, want = torch_serve.describe(tr, V), jax_serve.describe(jr, V)
        kinds.add(want.split("=")[0])
        if want.startswith("top="):
            assert abs(float(got[4:]) - float(want[4:])) <= PR_ATOL
        else:
            assert got == want
    assert kinds == {"inserted", "hits", "top", "reachable", "components"}
    assert np.array_equal(np_of(ts.in_degree), np_of(js.in_degree))


def test_serve_main_on_cpu_and_cuda_guard():
    out = torch_serve.main(["--device", "cpu", "--vertices", "128",
                            "--initial-edges", "600", "--requests", "8",
                            "--batch", "32"])
    store, ledger = out["store"], out["ledger"]
    assert store.version == 2 and store.n_edges == len(ledger)
    assert set(out["latency"]) == {"update", "property", "member"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            torch_serve.main(["--vertices", "16", "--initial-edges", "40"])


def test_pipeline_coalesces_and_quarantines():
    V = 32
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, V, 80), rng.integers(0, V, 80)
    js = jstream.GraphStore.from_edges(V, src, dst)
    ts = tstream.GraphStore.from_edges(V, src, dst, device="cpu")
    reqs = [dict(ins_src=[1, 2], ins_dst=[3, 4], del_src=src[:3],
                 del_dst=dst[:3]),
            dict(ins_src=[5], ins_dst=[6], del_src=[1], del_dst=[3]),
            dict(ins_src=[1], ins_dst=[3])]
    jout = jstream.RequestPipeline(js).run(
        [jstream.UpdateBatch(**r) for r in reqs]
        + [jstream.MembershipQuery([1, 5, 2], [3, 6, 4])])
    tout = tstream.RequestPipeline(ts).run(
        [tstream.UpdateBatch(**r) for r in reqs]
        + [tstream.MembershipQuery([1, 5, 2], [3, 6, 4])])
    assert tout[0].payload == jout[0].payload
    assert np.array_equal(tout[-1].payload["found"], jout[-1].payload["found"])
    for view in ("forward", "transpose", "symmetric"):
        assert_pools_equal(ts.views[view], js.views[view], view)
    nj = js.neighbors([0, 1, 2], out_capacity=64)
    nt = ts.neighbors([0, 1, 2], out_capacity=64)
    for a, b in zip(nt, nj):
        assert np.array_equal(np_of(a), np_of(b))
    bad, = tstream.RequestPipeline(ts).run(
        [tstream.UpdateBatch(ins_src=[V + 1], ins_dst=[0])])
    assert bad.kind == "error" and bad.payload["error"] == "QuarantinedBatch"
