"""Port parity: the slab_intersect family (triangle counting's engine)
against the JAX reference on the CPU.

The reference's kernels run in interpret mode.  The port lists only the
active (edge, bucket) items of the reference's dense layout, so its items
and per-item counts are compared with the dense layout's active slots.
Everything here is integer: per-item counts, totals, candidate rows and
membership answers must be bit-identical (no tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_vectors_equal, ids, to_port
from test_torch_gpu import PROBE_CASES, probe_inputs
from test_triangle_stream import _und_graph

from repro.algorithms import search_edges as jsearch_edges
from repro.core import from_edges_host
from repro.kernels import slab_intersect as jsi
from repro.kernels.slab_intersect.ops import _work_items as j_work_items
from repro_torch.kernels import slab_intersect as tsi
from repro_torch.kernels.slab_intersect.ops import _work_items


def _case(seed, hashing, pair):
    """A random undirected graph G1 and the (G2, edges) Count() reads: G1
    itself, or a second, sparser graph of the other bucket layout."""
    rng = np.random.default_rng(seed)
    V = int(rng.integers(16, 80))
    E = int(rng.integers(100, 200))
    src = rng.integers(0, V, E).astype(np.uint32)
    dst = rng.integers(0, V, E).astype(np.uint32)
    g1 = _und_graph(V, src, dst, hashing=hashing)
    g2 = g1
    if pair == "cross":
        src = rng.integers(0, V, 40).astype(np.uint32)
        dst = rng.integers(0, V, 40).astype(np.uint32)
        g2 = _und_graph(V, src, dst, hashing=not hashing)
    mask = rng.random(len(src)) < 0.9
    return g1, g2, src, dst, mask


@pytest.mark.parametrize("pair", ["same", "cross"])
@pytest.mark.parametrize("hashing", [True, False])
def test_slab_count_per_item_matches_pallas(hashing, pair):
    """The port's items are the reference's active dense slots in order,
    and their counts, scattered back to those slots, are the reference
    kernel's dense output."""
    g1, g2, src, dst, mask = _case(3 + 2 * hashing + (pair == "cross"),
                                   hashing, pair)
    mb = int(jnp.max(g2.bucket_count))
    jcur, ju, jm = j_work_items(g2, jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(mask), max_bpv=mb)
    t1 = to_port(g1)
    t2 = t1 if pair == "same" else to_port(g2)
    tstart, tu = _work_items(t2, ids(src), ids(dst), torch.from_numpy(mask),
                             max_bpv=mb)
    active = np.asarray(jm)
    assert_vectors_equal(tstart, np.asarray(jcur)[active], "start")
    assert_vectors_equal(tu, np.asarray(ju)[active], "u")
    want = jsi.slab_count_pallas(g1.keys, g1.next_slab, g1.bucket_offset,
                                 g1.bucket_count, g2.keys, g2.next_slab,
                                 jcur, ju, interpret=True)
    args = (t1.keys, t1.next_slab, t1.bucket_offset, t1.bucket_count,
            t2.keys, t2.next_slab, tstart, tu)
    got = tsi.slab_count_torch(*args)
    dense = np.zeros(active.shape, np.int32)
    dense[active] = got.numpy()
    assert_vectors_equal(dense, want, "per-item counts")
    assert int(want.sum()) > 0
    # on CPU tensors the wrapper is its plain version
    assert torch.equal(tsi.slab_count(*args), got)


@pytest.mark.parametrize("max_bpv", [1, 2, "max", "2max"])
@pytest.mark.parametrize("seed", [0, 1])
def test_work_items_are_the_active_dense_slots(seed, max_bpv):
    """Below G2's largest bucket count ``max_bpv`` truncates the buckets an
    edge enumerates, as the dense layout does; above it nothing changes.
    The totals follow the reference's at the same bound."""
    rng = np.random.default_rng(11 + seed)
    V = 400
    src = rng.integers(0, V, 900).astype(np.uint32)
    dst = rng.integers(0, V, 900).astype(np.uint32)
    src[:300], dst[:300] = 3, rng.permutation(V)[:300]   # a 4-bucket hub
    g1 = _und_graph(V, src, dst, hashing=True)
    g2 = _und_graph(V, np.r_[src[:300], src[300::2]],
                    np.r_[dst[:300], dst[300::2]], hashing=True)
    mb = int(jnp.max(g2.bucket_count))
    assert mb > 2
    bpv = {"max": mb, "2max": 2 * mb}.get(max_bpv, max_bpv)
    eu = rng.integers(0, V, 256).astype(np.uint32)
    ev = np.where(rng.random(256) < 0.3, 3, rng.integers(0, V, 256)
                  ).astype(np.uint32)
    mask = rng.random(256) < 0.8
    us, vs, m = jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(mask)
    jcur, ju, jm = j_work_items(g2, us, vs, m, max_bpv=bpv)
    t1, t2 = to_port(g1), to_port(g2)
    targs = (ids(eu), ids(ev), torch.from_numpy(mask))
    tstart, tu = _work_items(t2, *targs, max_bpv=bpv)
    active = np.asarray(jm)
    assert tstart.numel() == int(active.sum()) > 0
    assert_vectors_equal(tstart, np.asarray(jcur)[active], "start")
    assert_vectors_equal(tu, np.asarray(ju)[active], "u")
    want = int(jsi.count_edges_ref(g1, g2, us, vs, m, max_bpv=bpv))
    assert int(tsi.count_edges(t1, t2, *targs, max_bpv=bpv)) == want


def test_no_active_item_counts_zero():
    """Every edge masked out: no item, a zero total, and the wrapper takes
    an empty item list."""
    g1, g2, src, dst, mask = _case(0, True, "same")
    t = to_port(g1)
    none = torch.zeros(len(src), dtype=torch.bool)
    start, u = _work_items(t, ids(src), ids(dst), none, max_bpv=4)
    assert start.shape == u.shape == (0,)
    assert start.dtype == u.dtype == torch.int32
    got = tsi.slab_count(t.keys, t.next_slab, t.bucket_offset,
                         t.bucket_count, t.keys, t.next_slab, start, u)
    assert got.shape == (0,) and got.dtype == torch.int32
    total = tsi.count_edges(t, t, ids(src), ids(dst), none, max_bpv=4)
    assert total.dtype == torch.int64 and int(total) == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_count_edges_matches_reference(seed):
    hashing = bool(seed % 2)
    g1, g2, src, dst, mask = _case(seed, hashing,
                                   "cross" if seed >= 2 else "same")
    mb = int(jnp.max(g2.bucket_count))
    us, vs, m = jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask)
    want = int(jsi.count_edges_ref(g1, g2, us, vs, m, max_bpv=mb))
    assert want == int(jsi.count_edges(g1, g2, us, vs, m, impl="jnp",
                                       max_bpv=mb))
    t1, t2 = to_port(g1), to_port(g2)
    targs = (ids(src), ids(dst), torch.from_numpy(mask))
    for impl in ("auto", "torch", "oracle"):
        got = tsi.count_edges(t1, t2, *targs, impl=impl, max_bpv=mb)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == want, impl
    assert int(tsi.count_edges_ref(t1, t2, *targs, max_bpv=mb,
                                   lane_chunk=16)) == want


def test_count_edges_unknown_impl_raises():
    g = to_port(_und_graph(8, np.array([0], np.uint32),
                           np.array([1], np.uint32)))
    args = (g, g, ids([0]), ids([1]), torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown impl"):
        tsi.count_edges(*args, impl="pallas")
    with pytest.raises(ValueError, match="does not match"):
        tsi.count_edges(*args, impl="cuda")


@pytest.mark.parametrize("Q,C,S", [(8, 2, 16), (300, 4, 64), (1024, 8, 256)])
def test_probe_hits_matches(Q, C, S):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1000, (S, 128)).astype(np.uint32)
    keys[::7, ::3] = 0xFFFFFFFE                      # EMPTY lanes
    ws = rng.integers(0, 1000, Q).astype(np.uint32)
    ws[::11] = 0xFFFFFFFE                            # a sentinel key
    rows = rng.integers(-1, S, (Q, C)).astype(np.int32)
    want = jsi.probe_hits_pallas(jnp.asarray(ws), jnp.asarray(rows),
                                 jnp.asarray(keys), queries_per_block=128,
                                 interpret=True)
    assert np.array_equal(np.asarray(want), np.asarray(jsi.probe_hits_ref(
        jnp.asarray(ws), jnp.asarray(rows), jnp.asarray(keys))))
    tk = torch.from_numpy(keys.view(np.int32).copy())
    tw = torch.from_numpy(ws.view(np.int32).copy())
    tr = torch.from_numpy(rows)
    for fn in (tsi.probe_hits_torch, tsi.probe_hits, tsi.probe_hits_ref):
        assert_vectors_equal(fn(tw, tr, tk), want, fn.__name__)


@pytest.mark.parametrize("case", PROBE_CASES,
                         ids=[c[0] for c in PROBE_CASES])
def test_probe_hits_edge_cases(case):
    """The plain probe against the reference's Pallas kernel on the card
    test's edge cases (ids past the pool given to both as -1)."""
    ws, _, keys, rows, planted = probe_inputs(*case)
    want = jsi.probe_hits_pallas(
        jnp.asarray(ws.view(np.uint32)), jnp.asarray(rows),
        jnp.asarray(keys.view(np.uint32)), queries_per_block=128,
        interpret=True)
    got = tsi.probe_hits(torch.from_numpy(ws), torch.from_numpy(rows),
                         torch.from_numpy(keys))
    assert_vectors_equal(got, want, case[0])
    assert np.array_equal(got.numpy(), planted)


@pytest.fixture(scope="module")
def hashed():
    rng = np.random.default_rng(6)
    n = 256
    src = rng.integers(0, n, 400).astype(np.uint32)
    dst = rng.integers(0, n, 400).astype(np.uint32)
    src[:200] = 3                            # a vertex of three buckets
    dst[:200] = np.arange(200)
    gj = from_edges_host(n, src, dst, hashing=True)
    qs = rng.integers(0, n, 128).astype(np.uint32)
    qd = np.concatenate([dst[:64], rng.integers(0, n, 64)]).astype(np.uint32)
    qs[:64] = src[:64]
    mask = rng.random(128) < 0.9
    return gj, to_port(gj), qs, qd, mask


@pytest.mark.parametrize("max_chain", [1, 3, 8])
def test_adjacency_rows_and_chains_match(hashed, max_chain):
    gj, gt, qs, qd, mask = hashed
    mb = int(jnp.max(gj.bucket_count))
    assert mb > 1
    jm = jnp.asarray(mask)
    tm = torch.from_numpy(mask)
    assert_vectors_equal(
        tsi.adjacency_rows(gt, ids(qs), tm, max_bpv=mb, max_chain=max_chain),
        jsi.adjacency_rows(gj, jnp.asarray(qs), jm, max_bpv=mb,
                           max_chain=max_chain), "adjacency rows")
    assert_vectors_equal(
        tsi.materialize_chains(gt, ids(qs), ids(qd), tm,
                               max_chain=max_chain),
        jsi.materialize_chains(gj, jnp.asarray(qs), jnp.asarray(qd), jm,
                               max_chain=max_chain), "chains")


def test_search_edges_kernel_matches(hashed):
    gj, gt, qs, qd, mask = hashed
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    want = jsearch_edges(gj, jnp.asarray(qs), jnp.asarray(qd), jm)
    assert_vectors_equal(
        jsi.search_edges_kernel(gj, jnp.asarray(qs), jnp.asarray(qd), jm,
                                max_chain=8), want, "reference kernel path")
    assert int(np.asarray(want).sum()) > 0
    assert_vectors_equal(
        tsi.search_edges_kernel(gt, ids(qs), ids(qd), tm, max_chain=8),
        want, "port kernel path")
    assert_vectors_equal(tsi.search_edges_ref(gt, ids(qs), ids(qd), tm),
                         want, "oracle")


def test_search_edges_kernel_impl_matches_reference(hashed):
    """``impl="torch"`` (``probe_hits_ref``) against the reference's
    ``impl="ref"``; ``"cuda"`` on CPU tensors raises."""
    gj, gt, qs, qd, mask = hashed
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    want = jsi.search_edges_kernel(gj, jnp.asarray(qs), jnp.asarray(qd), jm,
                                   max_chain=8, impl="ref")
    assert int(np.asarray(want).sum()) > 0
    assert_vectors_equal(
        tsi.search_edges_kernel(gt, ids(qs), ids(qd), tm, max_chain=8,
                                impl="torch"), want, "impl=torch")
    with pytest.raises(ValueError, match="does not match"):
        tsi.search_edges_kernel(gt, ids(qs), ids(qd), tm, impl="cuda")
