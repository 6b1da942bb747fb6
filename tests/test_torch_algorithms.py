"""Port parity: SSSP/BFS trees, vanilla BFS levels, PageRank and the
frontier expansion against the JAX reference on the CPU.  Trees and levels
must be bit-identical (min family, integer sums and the same float32 adds);
PageRank is held to ``PR_ATOL`` (sum order, see
tests/test_torch_serve_slice.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ids, jids, np_of, to_port

from repro import algorithms as ja
from repro.core import batch as jbatch
from repro.core import slab_graph as jsg
from repro.core import worklist as jwl
from repro_torch import algorithms as ta
from repro_torch.core import worklist as twl
from repro_torch.core.batch import delete_edges, insert_edges

PR_ATOL = 2e-5
CAP = 4096


def _graphs(seed, weighted):
    rng = np.random.default_rng(seed)
    V = 120
    src, dst = rng.integers(0, V, 500), rng.integers(0, V, 500)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.integers(1, 4, len(src)).astype(np.float32) if weighted \
        else None
    kw = dict(hashing=False, slack_slabs=64)
    fwd = jsg.from_edges_host(V, src, dst, w, **kw)
    tr = jsg.from_edges_host(V, dst, src, w, **kw)
    return rng, src, dst, fwd, tr


def _same_tree(a, b):
    assert np.array_equal(np_of(a.dist), np_of(b.dist))
    assert np.array_equal(np_of(a.parent), np_of(b.parent))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sweep", [True, False])
def test_tree_static_incremental_decremental(weighted, sweep):
    rng, src, dst, fwd, tr = _graphs(1 + weighted, weighted)
    tf, tt = to_port(fwd), to_port(tr)
    jin, tin = (tr, tt) if sweep else (None, None)
    js, _ = ja.sssp_static(fwd, 0, edge_capacity=CAP, g_in=jin)
    ts, _ = ta.sssp_static(tf, 0, edge_capacity=CAP, g_in=tin)
    _same_tree(ts, js)

    # delete a slice of edges (tree edges among them), then re-insert some
    ds, dd = src[:60], dst[:60]
    fwd, jm = jbatch.delete_edges(fwd, jids(ds, 64), jids(dd, 64),
                                  impl="jnp")
    tr, _ = jbatch.delete_edges(tr, jids(dd, 64), jids(ds, 64), impl="jnp")
    tf, tm = delete_edges(tf, ids(ds, 64), ids(dd, 64))
    tt, _ = delete_edges(tt, ids(dd, 64), ids(ds, 64))
    jin, tin = (tr, tt) if sweep else (None, None)
    js, _ = ja.sssp_decremental(fwd, js, jids(ds, 64), jids(dd, 64), jm,
                                src=0, edge_capacity=CAP, g_in=jin)
    ts, _ = ta.sssp_decremental(tf, ts, ids(ds, 64), ids(dd, 64), tm,
                                src=0, edge_capacity=CAP, g_in=tin)
    _same_tree(ts, js)

    s2, d2 = rng.integers(0, 120, 30), rng.integers(0, 120, 30)
    w2 = np.pad(rng.integers(1, 4, 30), (0, 2)).astype(np.float32) \
        if weighted else None
    fwd, jm = jbatch.insert_edges(
        fwd, jids(s2, 32), jids(d2, 32),
        None if w2 is None else jnp.asarray(w2), impl="jnp")
    tr, _ = jbatch.insert_edges(
        tr, jids(d2, 32), jids(s2, 32),
        None if w2 is None else jnp.asarray(w2), impl="jnp")
    tw = None if w2 is None else torch.from_numpy(w2)
    tf, tm = insert_edges(tf, ids(s2, 32), ids(d2, 32), tw)
    tt, _ = insert_edges(tt, ids(d2, 32), ids(s2, 32), tw)
    bw = np.ones(32, np.float32) if w2 is None else w2
    jin, tin = (tr, tt) if sweep else (None, None)
    js, _ = ja.sssp_incremental(fwd, js, jids(s2, 32), jids(d2, 32),
                                jnp.asarray(bw), jm, edge_capacity=CAP,
                                g_in=jin)
    ts, _ = ta.sssp_incremental(tf, ts, ids(s2, 32), ids(d2, 32),
                                torch.from_numpy(bw), tm,
                                edge_capacity=CAP, g_in=tin)
    _same_tree(ts, js)


def test_bfs_tree_static_matches():
    _, _, _, fwd, tr = _graphs(4, False)
    js, ji = ja.bfs_tree_static(fwd, 3, edge_capacity=CAP, g_in=tr)
    ts, ti = ta.bfs_tree_static(to_port(fwd), 3, edge_capacity=CAP,
                                g_in=to_port(tr))
    _same_tree(ts, js)
    assert ti == int(ji)


def test_pagerank_matches():
    _, _, _, fwd, tr = _graphs(5, False)
    want, _ = ja.pagerank(tr, fwd.degree, contrib_impl="sweep")
    got, _ = ta.pagerank(to_port(tr), to_port(fwd).degree)
    np.testing.assert_allclose(got.numpy(), np_of(want), rtol=0,
                               atol=PR_ATOL)
    warm, _ = ta.pagerank_dynamic(to_port(tr), to_port(fwd).degree, got)
    np.testing.assert_allclose(warm.numpy(), np_of(want), rtol=0,
                               atol=PR_ATOL)


@pytest.mark.parametrize("contrib_impl", ["ref", "sweep", "pallas"])
def test_pagerank_contrib_impl_matches(contrib_impl):
    """Each of the reference's pool sweeps: the vector within PR_ATOL and
    the same iteration count, static and warm-started after deletes."""
    _, src, dst, fwd, tr = _graphs(5, False)
    want, wi = ja.pagerank(tr, fwd.degree, contrib_impl=contrib_impl)
    got, gi = ta.pagerank(to_port(tr), to_port(fwd).degree,
                          contrib_impl=contrib_impl)
    np.testing.assert_allclose(got.numpy(), np_of(want), rtol=0,
                               atol=PR_ATOL)
    assert gi == int(wi)
    ds, dd = src[:80], dst[:80]
    fwd, _ = jbatch.delete_edges(fwd, jids(ds, 128), jids(dd, 128),
                                 impl="jnp")
    tr, _ = jbatch.delete_edges(tr, jids(dd, 128), jids(ds, 128), impl="jnp")
    want, wi = ja.pagerank_dynamic(tr, fwd.degree, want,
                                   contrib_impl=contrib_impl)
    got, gi = ta.pagerank_dynamic(to_port(tr), to_port(fwd).degree, got,
                                  contrib_impl=contrib_impl)
    np.testing.assert_allclose(got.numpy(), np_of(want), rtol=0,
                               atol=PR_ATOL)
    assert gi == int(wi)


@pytest.mark.parametrize("contrib_impl", ["ref", "sweep", "pallas"])
def test_pagerank_stream_property_contrib_impl(contrib_impl):
    """The stream property with each pool sweep, against the reference's
    property with the same one, before and after an update."""
    from repro import stream as jstream
    from repro_torch import stream as tstream
    _, src, dst, _, _ = _graphs(6, False)
    kw = dict(hashing=False, with_symmetric=False, slack_slabs=64)
    js = jstream.GraphStore.from_edges(120, src, dst, **kw)
    ts = tstream.GraphStore.from_edges(120, src, dst, device="cpu", **kw)
    jreg, treg = jstream.PropertyRegistry(js), tstream.PropertyRegistry(ts)
    jreg.register(ja.pagerank_stream_property(contrib_impl=contrib_impl))
    treg.register(ta.pagerank_stream_property(contrib_impl=contrib_impl))
    for step in range(2):
        np.testing.assert_allclose(treg.read("pagerank").numpy(),
                                   np_of(jreg.read("pagerank")), rtol=0,
                                   atol=PR_ATOL)
        if step == 0:
            js.apply(del_src=src[:40], del_dst=dst[:40])
            ts.apply(del_src=src[:40], del_dst=dst[:40])


def test_pagerank_unknown_contrib_impl_raises():
    _, _, _, fwd, tr = _graphs(5, False)
    with pytest.raises(ValueError, match="contrib_impl"):
        ja.pagerank(tr, fwd.degree, contrib_impl="dense")
    with pytest.raises(ValueError, match="contrib_impl"):
        ta.pagerank(to_port(tr), to_port(fwd).degree, contrib_impl="dense")


def test_expand_vertices_matches():
    rng = np.random.default_rng(6)
    V = 64
    src = np.concatenate([np.zeros(200, np.int64), rng.integers(0, V, 200)])
    dst = np.concatenate([np.arange(200) % V, rng.integers(0, V, 200)])
    g = jsg.from_edges_host(V, src, dst, rng.uniform(0, 1, 400)
                            .astype(np.float32), hashing=True)
    gt = to_port(g)
    bpv = int(np.asarray(g.bucket_count).max())
    verts = np.asarray([0, 5, 9, 63], np.uint32)
    mask = np.asarray([True, True, False, True])
    for cap in (512, 64):
        want = jwl.expand_vertices(g, jnp.asarray(verts), jnp.asarray(mask),
                                   out_capacity=cap, max_bpv=bpv)
        got = twl.expand_vertices(gt, torch.from_numpy(verts.view(np.int32)),
                                  torch.from_numpy(mask), out_capacity=cap,
                                  max_bpv=bpv)
        for a, b in zip(got, want):
            assert np.array_equal(np_of(a), np_of(b))


@pytest.mark.parametrize("hashing", [False, True])
def test_bfs_vanilla_matches(hashing):
    """Both bodies of the level-synchronous BFS: the ``sum`` sweep of the
    frontier over the transpose, and the frontier expansion, with room for
    every edge and with a buffer that drops some.  Hashed, two buckets a
    vertex."""
    rng = np.random.default_rng(9)
    V = 64
    src, dst = rng.integers(0, V, 200), rng.integers(0, V, 200)
    if hashing:
        fwd = jsg.empty(V, np.full(V, 2, np.int32), 512)
        fwd, _ = jbatch.insert_edges(fwd, jids(src, 256), jids(dst, 256))
    else:
        fwd = jsg.from_edges_host(V, src, dst, hashing=False)
    tr = jwl.transpose_host(fwd, hashing=hashing)
    tf, tt = to_port(fwd), to_port(tr)
    bpv = int(np.asarray(fwd.bucket_count).max())
    levels = []
    for cap, jin, tin in ((CAP, tr, tt), (CAP, None, None), (8, None, None)):
        want, wit = ja.bfs_vanilla(fwd, src=3, edge_capacity=cap,
                                   max_bpv=bpv, g_in=jin)
        got, git = ta.bfs_vanilla(tf, src=3, edge_capacity=cap,
                                  max_bpv=bpv, g_in=tin)
        assert np.array_equal(np_of(got), np_of(want)), (cap, tin is None)
        assert git == int(wit)
        levels.append(got)
    assert torch.equal(levels[0], levels[1])
    assert int((levels[0] < ta.UNREACHED).sum()) > V // 2


@pytest.mark.parametrize("sweep", [True, False])
def test_run_to_convergence_takes_improved0(sweep):
    """The frontier is the reference's keyword ``improved0``: the same
    tree and iterations from a seeded source."""
    from repro.algorithms import sssp as jsssp
    from repro_torch.algorithms import sssp as tsssp
    rng, src, dst, fwd, tr = _graphs(7, True)
    tf, tt = to_port(fwd), to_port(tr)
    V = fwd.n_vertices
    j0, t0 = jsssp.init_state(V, 5), tsssp.init_state(V, 5, "cpu")
    jimp = jnp.zeros((V,), bool).at[5].set(True)
    timp = torch.zeros(V, dtype=torch.bool)
    timp[5] = True
    js, jit = jsssp.run_to_convergence(fwd, j0, improved0=jimp,
                                       edge_capacity=CAP,
                                       g_in=tr if sweep else None)
    ts, tit = tsssp.run_to_convergence(tf, t0, improved0=timp,
                                       edge_capacity=CAP,
                                       g_in=tt if sweep else None)
    _same_tree(ts, js)
    assert tit == int(jit) > 1
