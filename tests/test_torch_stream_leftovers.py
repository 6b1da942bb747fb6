"""Port parity for the main path's remaining names: the SSSP stream
property, ``slab_contrib_sums_ref``, ``INVALID_LANE``, ``union_find.find``,
the ``core`` re-exports and the synthetic ``uniform_edges`` /
``edge_batches``, each against the reference's.

The SSSP tree is compared bit for bit (distances are float32 sums along
the same paths in both packages), as in the reference's
``test_match_static_recompute_across_epochs``; the slab sums within
``rtol=1e-6``, since the two packages add a slab's lanes in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ids, jids, np_of, to_port

import repro.core as jcore
from repro import algorithms as jalg
from repro import stream as jstream
from repro.core.union_find import find as jfind
from repro.core.worklist import pool_edges as jpool_edges
from repro.data import synth as jsynth
import repro_torch.core as tcore
from repro_torch import algorithms as talg
from repro_torch import stream as tstream
from repro_torch.core.union_find import find, init_parents, union_batch
from repro_torch.core.worklist import pool_edges
from repro_torch.data import synth as tsynth

V = 24
CAP = 4096


def _epochs(seed, n=3):
    """Mixed epochs of inserts (weighted) and deletes, half of them of
    present edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, 80).astype(np.uint32)
    dst = rng.integers(0, V, 80).astype(np.uint32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.5, 3.0, len(src)).astype(np.float32)
    present = set(zip(src.tolist(), dst.tolist()))
    out = []
    for _ in range(n):
        ins = rng.integers(0, V, (10, 2)).astype(np.uint32)
        ins = ins[ins[:, 0] != ins[:, 1]]
        pres = np.array(sorted(present), np.uint32)
        hits = pres[rng.choice(len(pres), 2, replace=False)]
        dels = np.concatenate([hits, rng.integers(0, V, (2, 2))
                               .astype(np.uint32)])
        iw = rng.uniform(0.5, 3.0, len(ins)).astype(np.float32)
        present -= {(int(s), int(d)) for s, d in dels}
        present |= {(int(s), int(d)) for s, d in ins}
        out.append((ins[:, 0], ins[:, 1], iw, dels[:, 0], dels[:, 1]))
    return (src, dst, w), out


@pytest.mark.parametrize("policy", ["lazy", "eager"])
def test_sssp_stream_property_matches_reference(policy):
    (src, dst, w), epochs = _epochs(5)
    store = tstream.GraphStore.from_edges(V, src, dst, w, device="cpu")
    jstore = jstream.GraphStore.from_edges(V, src, dst, w)
    reg, jreg = (tstream.PropertyRegistry(store),
                 jstream.PropertyRegistry(jstore))
    reg.register(talg.sssp_stream_property(0, edge_capacity=CAP),
                 policy=policy)
    jreg.register(jalg.sssp_stream_property(0, edge_capacity=CAP),
                  policy=policy)
    for batch in epochs:
        store.apply(*batch)
        jstore.apply(*batch)
        got, want = reg.read("sssp_0"), jreg.read("sssp_0")
        assert np.array_equal(np_of(got.dist), np_of(want.dist))
        assert np.array_equal(np_of(got.parent), np_of(want.parent))
        static, _ = talg.sssp_static(store.forward, 0, edge_capacity=CAP,
                                     g_in=store.transpose)
        assert torch.equal(got.dist, static.dist)
        assert torch.equal(got.parent, static.parent)
    # the unit-weight tree of an unweighted store is the BFS tree
    ustore = tstream.GraphStore.from_edges(V, src, dst, device="cpu")
    ureg = tstream.PropertyRegistry(ustore)
    ureg.register(talg.sssp_stream_property(0, edge_capacity=CAP))
    ureg.register(talg.bfs_stream_property(0, edge_capacity=CAP))
    for i_s, i_d, _, d_s, d_d in epochs:
        ustore.apply(i_s, i_d, None, d_s, d_d)
    a, b = ureg.read("sssp_0"), ureg.read("bfs_0")
    assert torch.equal(a.dist, b.dist) and torch.equal(a.parent, b.parent)
    with pytest.raises(ValueError, match="unweighted"):
        tstream.PropertyRegistry(store).register(
            talg.bfs_stream_property(0, edge_capacity=CAP))


def test_state_like_of_every_stream_property():
    like = {"pagerank": (torch.float32,), "bfs_0": (torch.float32,
                                                    torch.int32),
            "sssp_0": (torch.float32, torch.int32), "wcc": (torch.int32,),
            "triangles": (torch.int64,)}
    specs = [talg.pagerank_stream_property(),
             talg.bfs_stream_property(0, edge_capacity=CAP),
             talg.sssp_stream_property(0, edge_capacity=CAP),
             talg.wcc_stream_property(), talg.triangle_stream_property()]
    for spec in specs:
        state = spec.state_like(V)
        parts = state if isinstance(state, tuple) else (state,)
        assert tuple(p.dtype for p in parts) == like[spec.name]
        want = () if spec.name == "triangles" else (V,)
        assert all(tuple(p.shape) == want for p in parts)


def test_slab_contrib_sums_ref_matches_reference():
    rng = np.random.default_rng(2)
    src = rng.integers(0, V, 300).astype(np.uint32)
    dst = rng.integers(0, V, 300).astype(np.uint32)
    jstore = jstream.GraphStore.from_edges(V, src, dst)
    jg = jstore.transpose
    g = to_port(jg)
    contrib = rng.random(V).astype(np.float32)
    want = jalg.slab_contrib_sums_ref(jg.keys, jpool_edges(jg).valid,
                                      jnp.asarray(contrib))
    got = talg.slab_contrib_sums_ref(g.keys, pool_edges(g).valid,
                                     torch.from_numpy(contrib))
    assert got.dtype == torch.float32
    # the 128 lanes of a slab are added in another order than XLA's: a few
    # float32 ulp of the slab total
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert np.array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_find_and_invalid_lane_match_reference():
    assert tcore.INVALID_LANE == int(jcore.INVALID_LANE) == -1
    rng = np.random.default_rng(4)
    u, v = rng.integers(0, V, (2, 30))
    parent = union_batch(init_parents(V, "cpu"), ids(u), ids(v),
                         torch.ones(30, dtype=torch.bool))
    q = rng.integers(0, V, 16)
    got = find(parent, ids(q))
    want = jfind(jcore.union_batch(jcore.init_parents(V), jids(u).astype(
        np.int32), jids(v).astype(np.int32), np.ones(30, bool)),
        jids(q).astype(np.int32))
    assert np.array_equal(np_of(got), np_of(want))


@pytest.mark.parametrize("weighted", [False, True])
def test_uniform_edges_and_edge_batches_match_reference(weighted):
    got = tsynth.uniform_edges(50, 400, seed=7, weighted=weighted)
    want = jsynth.uniform_edges(50, 400, seed=7, weighted=weighted)
    assert len(got) == len(want) == (3 if weighted else 2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for pad in (None, 128):
        pairs = zip(tsynth.edge_batches(got[0], got[1], 96, pad_to=pad),
                    jsynth.edge_batches(want[0], want[1], 96, pad_to=pad))
        n = 0
        for a, b in pairs:
            n += 1
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        assert n == -(-len(got[0]) // 96)


def test_every_reference_core_name_is_importable_from_the_port():
    missing = [n for n in jcore.__all__ if not hasattr(tcore, n)]
    assert missing == []
    assert set(jcore.__all__) <= set(tcore.__all__)
    from repro_torch.core import batch
    for name in ("apply_update", "delete_edges", "insert_edges",
                 "query_edges", "probe", "update_views"):
        assert getattr(tcore, name) is getattr(batch, name)
