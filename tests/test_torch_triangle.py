"""Port parity: triangle counting (static, incremental, decremental, the
batch graph, the canonical-pair helpers and the live stream property)
against the JAX reference on the CPU.

Counts are compared as Python ints and pools leaf for leaf; everything is
integer, so nothing has a tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_maintenance_equal, assert_pools_equal,
                         assert_vectors_equal, ids, jids, to_port)
from test_triangle_stream import _brute, _churn_script, _und_graph

from repro import stream as jstream
from repro.algorithms import triangle as jtri
from repro_torch import stream as tstream
from repro_torch.algorithms import triangle as ttri
from repro_torch.algorithms import triangle_stream_property


def _loop_free(rng, V, E):
    lo, hi = ttri.undirected_host(rng.integers(0, V, E).astype(np.uint32),
                                  rng.integers(0, V, E).astype(np.uint32))
    keep = lo != hi
    return lo[keep], hi[keep]


@pytest.mark.parametrize("max_edges", [16, None, 4096])
def test_compact_edges_matches(max_edges):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 32, 200).astype(np.uint32)
    dst = rng.integers(0, 32, 200).astype(np.uint32)
    gj = _und_graph(32, src, dst)
    live = int(jnp.sum(jtri.compact_edges(gj, max_edges=4096)[2]))
    cap = live if max_edges is None else max_edges
    want = jtri.compact_edges(gj, max_edges=cap)
    got = ttri.compact_edges(to_port(gj), max_edges=cap)
    for a, b, what in zip(got, want, ("src", "dst", "count", "overflow")):
        assert_vectors_equal(a, b, what)
    assert int(got[3]) == max(live - cap, 0)


def test_triangles_static_grows_past_small_cap():
    rng = np.random.default_rng(6)
    lo, hi = _loop_free(rng, 40, 300)
    gj = _und_graph(40, lo, hi)
    gt = to_port(gj)
    mb = jtri._sym_bpv(gj)
    assert ttri._sym_bpv(gt) == mb
    want = _brute(40, lo, hi)
    assert int(jtri.triangles_static(gj, max_bpv=mb, max_edges=32)) == want
    for impl in ("auto", "oracle"):
        got = ttri.triangles_static(gt, max_bpv=mb, max_edges=32, chunk=64,
                                    impl=impl)
        assert got.dtype == torch.int64 and int(got) == want, impl


def test_triangles_static_total_is_int64(monkeypatch):
    """Four chunks of 2**30 each: the total passes 2**31 without wrapping,
    where the reference's int32 accumulator would."""
    rng = np.random.default_rng(7)
    lo, hi = _loop_free(rng, 32, 200)
    gt = to_port(_und_graph(32, lo, hi))
    n = int(gt.n_edges)
    chunk = -(-n // 4)
    calls = []

    def stub(g1, g2, us, vs, emask, **kw):
        calls.append(int(emask.sum()))
        return torch.tensor(2 ** 30, dtype=torch.int64)

    monkeypatch.setattr(ttri, "count_edges", stub)
    got = ttri.triangles_static(gt, chunk=chunk)
    assert len(calls) == 4 and sum(calls) == n
    assert got.dtype == torch.int64
    assert int(got) == (4 * 2 ** 30) // 6


def test_undirected_host_matches():
    rng = np.random.default_rng(9)
    src = rng.integers(0, 50, 400).astype(np.uint32)
    dst = rng.integers(0, 50, 400).astype(np.uint32)
    for a, b in zip(ttri.undirected_host(src, dst),
                    jtri.undirected_host(src, dst)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _pairs(seed):
    """Canonical pairs with repeats, reversed twins (as their lo/hi), ids at
    and above 2**31 and masked lanes."""
    rng = np.random.default_rng(seed)
    B = 96
    a = rng.integers(0, 24, B).astype(np.uint32)
    b = rng.integers(0, 24, B).astype(np.uint32)
    a[:8] = 0x80000000 + np.arange(8, dtype=np.uint32)   # negative as int32
    b[8:16] = 0xFFFFFFF0
    a[40:60], b[40:60] = b[20:40], a[20:40]               # reversed twins
    a[60:70], b[60:70] = a[:10], b[:10]                   # repeats
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    mask = rng.random(B) < 0.85
    return lo, hi, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_and_pair_duplicated_match(seed):
    lo, hi, mask = _pairs(seed)
    jargs = (jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(mask))
    targs = (ids(lo), ids(hi), torch.from_numpy(mask))
    for name in ("dedup_canonical", "pair_duplicated"):
        want = getattr(jtri, name)(*jargs)
        got = getattr(ttri, name)(*targs)
        assert_vectors_equal(got, want, name)
        assert 0 < int(got.sum()) < int(mask.sum()), name


def test_batch_graph_leaf_identical():
    lo, hi, mask = _pairs(2)
    keep = mask & (hi < 24) & (lo != hi)     # vertex ids, loop-free
    V = 24
    jdk = jtri.dedup_canonical(jnp.asarray(lo), jnp.asarray(hi),
                               jnp.asarray(keep))
    tdk = ttri.dedup_canonical(ids(lo), ids(hi), torch.from_numpy(keep))
    want = jtri.batch_graph(V, jnp.asarray(lo), jnp.asarray(hi), jdk)
    got = ttri.batch_graph(V, ids(lo), ids(hi), tdk)
    assert_pools_equal(got, want, "batch graph")
    assert int(got.n_edges) == 2 * int(tdk.sum())


@pytest.mark.parametrize("impl", ["auto", "oracle"])
def test_incremental_and_decremental_match(impl):
    rng = np.random.default_rng(12)
    V = 40
    lo, hi = _loop_free(rng, V, 240)
    cut = len(lo) - 24                         # the batch: the last pairs
    g_old = _und_graph(V, lo[:cut], hi[:cut])
    g_new = _und_graph(V, lo, hi)
    B = 32
    bm = np.arange(B) < 24
    jb = jtri.batch_graph(V, jids(lo[cut:], B), jids(hi[cut:], B),
                          jnp.asarray(bm))
    tb = ttri.batch_graph(V, ids(lo[cut:], B), ids(hi[cut:], B),
                          torch.from_numpy(bm))
    assert_pools_equal(tb, jb, "batch graph")
    delta = _brute(V, lo, hi) - _brute(V, lo[:cut], hi[:cut])
    assert delta > 0
    jargs = (jids(lo[cut:], B), jids(hi[cut:], B), jnp.asarray(bm))
    targs = (ids(lo[cut:], B), ids(hi[cut:], B), torch.from_numpy(bm))
    mb = jtri._sym_bpv(g_new)
    for fn, g in (("triangles_incremental", g_new),
                  ("triangles_decremental", g_old)):
        want = getattr(jtri, fn)(g, jb, *jargs, max_bpv=mb, batch_bpv=1)
        got = getattr(ttri, fn)(to_port(g), tb, *targs, max_bpv=mb,
                                batch_bpv=1, impl=impl)
        assert got.dtype == torch.int64
        assert int(got) == int(want) == delta, fn


@pytest.mark.parametrize("loops", [True, False])
def test_stream_property_churn_matches(loops, monkeypatch):
    """Both packages serve the reference's 24-epoch churn script under a
    maintenance policy.  After every epoch the counts, the three views'
    pools, the versions and the maintenance counters agree, and a static
    recount equals the maintained count.

    With ``loops`` the graph and script are the reference's own, whose
    self-loops send every epoch to the recount; without, the loops are
    moved off the diagonal, so insert-only and delete-only epochs take the
    incremental and decremental deltas (mixed epochs still recount).
    """
    rng = np.random.default_rng(21)
    V = 48
    src = rng.integers(0, V, 260).astype(np.uint32)
    dst = rng.integers(0, V, 260).astype(np.uint32)

    def off_diagonal(s, d):
        return d if loops or s is None else \
            np.where(s == d, (d + 1) % V, d).astype(np.uint32)

    dst = off_diagonal(src, dst)
    deltas = []
    for name in ("triangles_incremental", "triangles_decremental"):
        def counted(*a, _fn=getattr(ttri, name), _name=name, **kw):
            deltas.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(ttri, name, counted)
    policy = dict(tombstone_ratio=0.05, every=7)
    js = jstream.GraphStore.from_edges(
        V, src, dst, hashing=True,
        maintenance=jstream.MaintenancePolicy(**policy))
    ts = tstream.GraphStore.from_edges(
        V, src, dst, hashing=True,
        maintenance=tstream.MaintenancePolicy(**policy), device="cpu")
    jspec, tspec = jtri.stream_property(), triangle_stream_property()
    jreg, treg = jstream.PropertyRegistry(js), tstream.PropertyRegistry(ts)
    jreg.register(jspec)
    treg.register(tspec)
    assert int(treg.read("triangles")) == int(jreg.read("triangles")) > 0
    live = set(zip(src.tolist(), dst.tolist()))
    for ep, (i_s, i_d, d_s, d_d) in enumerate(
            _churn_script(rng, V, 24, live)):
        kw = dict(ins_src=i_s, ins_dst=off_diagonal(i_s, i_d),
                  del_src=d_s, del_dst=d_d)
        js.apply(**kw)
        ts.apply(**kw)
        got = treg.read("triangles")
        assert got.dtype == torch.int64
        assert int(got) == int(jreg.read("triangles")), ep
        assert int(tspec.refresh(ts)) == int(got) == int(jspec.refresh(js))
        for name, g in js.views.items():
            assert_pools_equal(ts.views[name], g, f"epoch {ep}: {name}")
        assert_maintenance_equal(ts, js, f"epoch {ep}")
    assert ts.maintenance_count > 0
    if loops:
        assert not deltas
    else:
        assert {"triangles_incremental",
                "triangles_decremental"} <= set(deltas)
