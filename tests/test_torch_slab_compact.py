"""Port parity: slab compaction and reclamation against the JAX reference on
the CPU.

The plain census and chain walk must equal the reference's Pallas kernels
(interpret mode), every output bit for bit.  The port's ``compact`` (the
plain plan, ``impl="torch"``, and the sort-based ``"oracle"``) must leave
pools leaf-identical to the reference's oracle, with an equal slab map and
report; ``reclaim_free_slabs`` likewise, and an insert after it must drain
the free list as the reference's does.  Everything here is integer: no
tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_pools_equal, assert_reports_equal,
                         assert_vectors_equal, ids, np_of, to_port)
from test_torch_slab_layout import permuted_rows

from repro.core import (delete_edges, ensure_capacity, from_edges_host,
                        insert_edges, update_slab_pointers)
from repro.core.worklist import pool_edges
from repro.kernels.slab_compact import compact as jax_compact
from repro.kernels.slab_compact import reclaim_free_slabs as jax_reclaim
from repro.kernels.slab_compact.kernel import (chain_rank_pallas,
                                               slab_live_pallas)
from repro_torch.core import batch as tbatch
from repro_torch.core.slab_graph import pool_stats
from repro_torch.kernels.slab_compact import (chain_rank, compact,
                                              live_lane_mask,
                                              reclaim_free_slabs, slab_live)


def churned_graph(rng, *, n_vertices=300, n_edges=5000, epochs=4, batch=512,
                  hashing=False, weighted=False):
    """A reference graph after mixed epochs: tombstones, grown chains."""
    src = rng.integers(0, n_vertices, n_edges).astype(np.uint32)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.uint32)
    w = rng.random(n_edges).astype(np.float32) if weighted else None
    g = from_edges_host(n_vertices, src, dst, w, hashing=hashing)
    for _ in range(epochs):
        di = rng.choice(n_edges, batch, replace=False)
        g = ensure_capacity(g, batch + 64)
        g, _ = delete_edges(g, jnp.asarray(src[di]), jnp.asarray(dst[di]))
        ins = rng.integers(0, n_vertices, (batch, 2)).astype(np.uint32)
        iw = (jnp.asarray(rng.random(batch).astype(np.float32))
              if weighted else None)
        g, _ = insert_edges(g, jnp.asarray(ins[:, 0]),
                            jnp.asarray(ins[:, 1]), iw)
        g = update_slab_pointers(g)
    return g, src, dst


def dead_slab_graph(rng):
    """Hubs with overflow chains, then every edge of ten hubs deleted:
    wholly dead overflow slabs."""
    V = 40
    src = np.repeat(np.arange(V, dtype=np.uint32), 300)
    dst = rng.integers(0, 100000, len(src)).astype(np.uint32)
    g = from_edges_host(V, src, dst, hashing=False)
    view = pool_edges(g)
    valid = np.asarray(view.valid)
    vs = np.asarray(view.src)[valid].astype(np.uint32)
    vd = np.asarray(view.dst)[valid]
    m = vs < 10
    g, _ = delete_edges(g, jnp.asarray(vs[m]), jnp.asarray(vd[m]))
    return update_slab_pointers(g)


def hub_graph(rng, hub_edges=40000):
    """A graph with a hub of ``hub_edges`` distinct out-edges (about 313
    slabs for 40,000), after a delete and an insert epoch: tombstones along
    the hub's chain and slabs the engine appended."""
    V = 200
    src = np.concatenate([np.full(hub_edges, 3), rng.integers(0, V, 2000)])
    dst = np.concatenate([rng.choice(10 ** 6, hub_edges, replace=False),
                          rng.integers(0, V, 2000)]).astype(np.uint32)
    src = src.astype(np.uint32)
    g = from_edges_host(V, src, dst, hashing=False)
    di = rng.choice(len(src), 3000, replace=False)
    g = ensure_capacity(g, 512)
    g, _ = delete_edges(g, jnp.asarray(src[di]), jnp.asarray(dst[di]))
    ins = np.stack([np.full(600, 3), rng.integers(10 ** 6, 2 * 10 ** 6, 600)],
                   1).astype(np.uint32)
    g, _ = insert_edges(g, jnp.asarray(ins[:, 0]), jnp.asarray(ins[:, 1]))
    return update_slab_pointers(g), src, dst


@pytest.mark.parametrize("layout", ["as built", "permuted"])
@pytest.mark.parametrize("pool", ["churned", "churned, hashed", "hub"])
def test_census_and_chain_walk_match_pallas(pool, layout):
    """The plain census and chain walk against the reference's kernels, on
    the pool as built and with its overflow rows relabelled."""
    rng = np.random.default_rng(5)
    g = (hub_graph(rng) if pool == "hub" else
         churned_graph(rng, hashing=pool == "churned, hashed"))[0]
    keys, nxt, owner = (np.array(g.keys), np.array(g.next_slab),
                        np.array(g.slab_vertex))
    if layout == "permuted":
        keys, nxt, owner = permuted_rows(keys, nxt, owner, g.n_buckets,
                                         seed=6)
    cnt_j, rank_j = slab_live_pallas(jnp.asarray(keys), jnp.asarray(owner),
                                     interpret=True)
    walk_j = chain_rank_pallas(jnp.asarray(nxt), cnt_j,
                               n_buckets=g.n_buckets, interpret=True)
    cnt, rank = slab_live(torch.from_numpy(keys.view(np.int32)),
                          torch.from_numpy(owner))
    assert_vectors_equal(cnt, cnt_j, "live count")
    assert_vectors_equal(rank, rank_j, "lane rank")
    walk = chain_rank(torch.from_numpy(nxt), cnt, g.n_buckets)
    for name, a, b in zip(("base_rank", "bucket_of", "chain_pos", "counts"),
                          walk, walk_j):
        assert_vectors_equal(a, b, name)
    assert int(walk[3].sum()) == int(g.n_edges)
    if pool == "hub":
        assert int(walk[2].max()) >= 312


@pytest.mark.parametrize("impl", ["torch", "oracle"])
@pytest.mark.parametrize("hashing,weighted", [(False, False), (False, True),
                                              (True, False), (True, True)])
def test_compact_matches_reference(impl, hashing, weighted):
    g, _, _ = churned_graph(np.random.default_rng(11), hashing=hashing,
                            weighted=weighted)
    gj, rep_j = jax_compact(g, impl="oracle")
    gt, rep_t = compact(to_port(g), impl=impl)
    assert_pools_equal(gt, gj, f"compact {impl}")
    assert_reports_equal(rep_t, rep_j, f"compact {impl}")
    assert pool_stats(gt)["tombstone_lanes"] == 0


@pytest.mark.parametrize("kw", [dict(shrink=True), dict(shrink=False)],
                         ids=["shrink", "keep"])
def test_freed_slabs_equal_reference(kw):
    """``CompactionReport.freed_slabs`` (old minus new ``next_free``) bit
    for bit, on a pool whose deletes leave slabs to free."""
    g = dead_slab_graph(np.random.default_rng(24))
    _, rep_j = jax_compact(g, **kw)
    _, rep_t = compact(to_port(g), **kw)
    assert rep_t.freed_slabs == rep_j.freed_slabs > 0
    assert rep_t.freed_slabs == rep_t.old_next_free - rep_t.new_next_free


@pytest.mark.parametrize("kw", [dict(shrink=True), dict(shrink=False),
                                dict(capacity_slabs=700)],
                         ids=["shrink", "keep", "pinned"])
def test_capacity_ladder_matches_reference(kw):
    g, src, dst = churned_graph(np.random.default_rng(24))
    # delete nearly everything: the survivors fit a lower rung
    g = ensure_capacity(g, len(src) + 64)
    g, _ = delete_edges(g, jnp.asarray(src), jnp.asarray(dst))
    g = update_slab_pointers(g)
    gj, rep_j = jax_compact(g, **kw)
    gt, rep_t = compact(to_port(g), **kw)
    assert_pools_equal(gt, gj, str(kw))
    assert_reports_equal(rep_t, rep_j, str(kw))
    if kw.get("shrink"):
        assert rep_t.shrunk
    elif "shrink" in kw:
        assert rep_t.new_capacity == g.capacity_slabs


def test_reclaim_then_insert_matches_reference():
    rng = np.random.default_rng(31)
    g = dead_slab_graph(rng)
    gj, n_j = jax_reclaim(g)
    gt, n_t = reclaim_free_slabs(to_port(g))
    assert n_t == n_j > 0
    assert_pools_equal(gt, gj, "reclaim")
    B = 1024
    ins = np.stack([rng.integers(0, 40, B),
                    rng.integers(200000, 300000, B)], 1).astype(np.uint32)
    gj2, m_j = insert_edges(gj, jnp.asarray(ins[:, 0]),
                            jnp.asarray(ins[:, 1]))
    top = int(gt.free_top)
    gt2, m_t = tbatch.insert_edges(gt, ids(ins[:, 0]), ids(ins[:, 1]))
    assert_vectors_equal(m_t, m_j, "inserted")
    assert_pools_equal(gt2, gj2, "insert after reclaim")
    assert int(gt2.free_top) < top


def test_compact_after_reclaim_matches_reference():
    """A non-empty free list and unlinked rows before the compaction."""
    g, _ = jax_reclaim(dead_slab_graph(np.random.default_rng(32)))
    gj, rep_j = jax_compact(g, impl="oracle")
    gt, rep_t = compact(to_port(g))
    assert_pools_equal(gt, gj, "compact after reclaim")
    assert_reports_equal(rep_t, rep_j)


def test_key_above_2_31_stays_live():
    """Keys are compared as uint32: global ids at or above 2**31 (int32
    bit patterns below zero) are live lanes, not sentinels."""
    rng = np.random.default_rng(41)
    V = 50
    src = rng.integers(0, V, 400).astype(np.uint32)
    dst = rng.integers(0, V, 400).astype(np.uint32)
    big = (2 ** 31 + np.arange(0, 7 * 8, 7)).astype(np.uint32)
    dst[:8] = big
    g = from_edges_host(V, src, dst, hashing=False)
    g, _ = delete_edges(g, jnp.asarray(src[100:160]),
                        jnp.asarray(dst[100:160]))
    g = update_slab_pointers(g)
    gt = to_port(g)
    assert int(live_lane_mask(gt.keys, gt.slab_vertex).sum()) == \
        int(g.n_edges)
    gj, rep_j = jax_compact(g, impl="oracle")
    gt, rep_t = compact(gt)
    assert_pools_equal(gt, gj, "ids >= 2**31")
    assert_reports_equal(rep_t, rep_j)
    assert rep_t.live_lanes == int(g.n_edges)
    assert np.isin(big, np_of(gt.keys).view(np.uint32)).all()


def test_impl_follows_the_tensors():
    g, _, _ = churned_graph(np.random.default_rng(3), epochs=1)
    with pytest.raises(ValueError, match="impl"):
        compact(to_port(g), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        compact(to_port(g), impl="pallas")
    a, _ = compact(to_port(g), impl="auto")
    b, _ = compact(to_port(g), impl="torch")
    for name in ("keys", "next_slab", "slab_vertex", "degree"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
