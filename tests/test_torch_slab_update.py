"""Port parity: the slab-update engine (probe, placement, commit) against
the JAX reference engine on the CPU.

The port's plain versions (``impl="torch"``) must leave pools leaf-identical
to the reference's ``impl="jnp"`` engine and to its Pallas kernels run in
interpret mode, across mixed epochs with overflow chains, tombstones,
deleted-then-reinserted pairs, a non-empty free list and duplicates inside a
batch.  The reference suite already holds those two JAX paths equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_pools_equal, ids, jids, np_of, to_port
from test_torch_slab_layout import permuted_rows

from repro.core import batch as jbatch
from repro.core import slab_graph as jsg
from repro.kernels.slab_compact import reclaim_free_slabs
from repro.kernels.slab_update.kernel import (slab_commit_pallas,
                                              slab_probe_pallas)
from repro_torch.core import batch as tbatch
from repro_torch.core import slab_graph as tsg
from repro_torch.kernels.slab_update.kernel import (slab_commit,
                                                    slab_commit_torch,
                                                    slab_probe)

JAX_IMPLS = {"jnp": dict(impl="jnp"),
             "pallas": dict(impl="pallas", interpret=True,
                            queries_per_tile=8, use_commit_kernel=True)}


def _epochs(rng, V, n_epochs, B):
    """Mixed insert/delete epochs with in-batch duplicates, re-inserts of
    deleted pairs and a hub that chains overflow slabs."""
    seen = []
    for e in range(n_epochs):
        s = rng.integers(0, V, B)
        d = rng.integers(0, V, B)
        s[: B // 4] = 0                              # hub -> overflow chains
        d[: B // 4] = rng.choice(V, B // 4, replace=False)
        s[-3:], d[-3:] = s[0], d[0]                   # duplicates in batch
        if seen and e % 2:
            back = seen[rng.integers(0, len(seen))]
            s[B // 4:B // 4 + len(back[0])] = back[0][:B // 4]
            d[B // 4:B // 4 + len(back[1])] = back[1][:B // 4]
        k = min(B // 2, len(s))
        ds = np.concatenate([s[:k], rng.integers(0, V, 4)])
        dd = np.concatenate([d[:k], rng.integers(0, V, 4)])
        seen.append((ds[:6], dd[:6]))
        yield s, d, ds, dd


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("weighted", [False, True])
def test_engine_leaf_identical_over_mixed_epochs(jax_impl, weighted):
    rng = np.random.default_rng(7 + weighted)
    V = 300
    kw = JAX_IMPLS[jax_impl]
    B = 64 if jax_impl == "jnp" else 32
    n_epochs = 6 if jax_impl == "jnp" else 3
    gj = jsg.empty(V, np.full(V, 2, np.int32), 512, weighted=weighted)
    gt = to_port(gj)
    for step, (s, d, ds, dd) in enumerate(_epochs(rng, V, n_epochs, B)):
        w = rng.uniform(0, 4, B).astype(np.float32) if weighted else None
        gj, mj = jbatch.insert_edges(
            gj, jids(s), jids(d), None if w is None else jnp.asarray(w),
            **kw)
        gt, mt = tbatch.insert_edges(
            gt, ids(s), ids(d), None if w is None else torch.from_numpy(w))
        assert np.array_equal(np_of(mt), np_of(mj))
        assert_pools_equal(gt, gj, f"insert {step}")

        P = 64
        gj, mj = jbatch.delete_edges(gj, jids(ds, P), jids(dd, P), **kw)
        gt, mt = tbatch.delete_edges(gt, ids(ds, P), ids(dd, P))
        assert np.array_equal(np_of(mt), np_of(mj))
        assert_pools_equal(gt, gj, f"delete {step}")

        q = jbatch.query_edges(gj, jids(s), jids(d), **kw)
        assert np.array_equal(
            np_of(tbatch.query_edges(gt, ids(s), ids(d))), np_of(q))
        if step % 2:
            gj, gt = jsg.update_slab_pointers(gj), \
                tsg.update_slab_pointers(gt)


def _interior(a, seg: int, gap: int):
    """``a`` with INVALID padding inside it: after every ``seg`` entries,
    ``gap`` pad lanes (each source rank's segment of a mesh epoch ends in
    its own padding); returns the padded ids and the entries' lanes."""
    a = np.asarray(a, np.int64)
    lanes = np.arange(len(a)) // seg * (seg + gap) + np.arange(len(a)) % seg
    out = np.full(lanes[-1] + gap + 1, 0xFFFFFFFF, np.int64)
    out[lanes] = a
    return out, lanes


@pytest.mark.parametrize("weighted", [False, True])
def test_engine_pools_do_not_depend_on_where_the_padding_sits(weighted):
    """The mesh epoch hands the engine batches with INVALID padding inside
    them and wider than the stacked rendering's.  Inserts, deletes and
    queries on such a batch give the packed batch's pools leaf for leaf
    (the reference's on the packed batch) and its masks at the entries'
    lanes, False on every pad."""
    rng = np.random.default_rng(31 + weighted)
    V, B = 300, 64
    gj = jsg.empty(V, np.full(V, 2, np.int32), 512, weighted=weighted)
    packed, inner = to_port(gj), to_port(gj)
    for step, (s, d, ds, dd) in enumerate(_epochs(rng, V, 4, B)):
        w = rng.uniform(0, 4, B).astype(np.float32) if weighted else None
        s_i, lanes = _interior(s, 16, 7)
        d_i, _ = _interior(d, 16, 7)
        w_i = None
        if weighted:
            w_i = np.zeros(len(s_i), np.float32)
            w_i[lanes] = w
        gj, mj = jbatch.insert_edges(
            gj, jids(s), jids(d), None if w is None else jnp.asarray(w),
            impl="jnp")
        packed, mp = tbatch.insert_edges(
            packed, ids(s), ids(d), None if w is None else torch.from_numpy(w))
        inner, mi = tbatch.insert_edges(
            inner, ids(s_i), ids(d_i),
            None if w_i is None else torch.from_numpy(w_i))
        assert np.array_equal(np_of(mp), np_of(mj))
        assert np.array_equal(np_of(mi)[lanes], np_of(mp))
        assert int(mi.sum()) == int(mp.sum())
        assert_pools_equal(packed, gj, f"packed insert {step}")
        assert_pools_equal(inner, gj, f"interior-padded insert {step}")

        ds_i, dlanes = _interior(ds, 8, 5)
        dd_i, _ = _interior(dd, 8, 5)
        gj, mj = jbatch.delete_edges(gj, jids(ds), jids(dd), impl="jnp")
        packed, mp = tbatch.delete_edges(packed, ids(ds), ids(dd))
        inner, mi = tbatch.delete_edges(inner, ids(ds_i), ids(dd_i))
        assert np.array_equal(np_of(mi)[dlanes], np_of(mj))
        assert int(mi.sum()) == int(mj.sum())
        assert_pools_equal(inner, gj, f"interior-padded delete {step}")
        q = tbatch.query_edges(inner, ids(s_i), ids(d_i))
        assert np.array_equal(np_of(q)[lanes], np_of(
            tbatch.query_edges(packed, ids(s), ids(d))))
        assert int(q.sum()) == int(q[lanes].sum())
        if step % 2:
            gj = jsg.update_slab_pointers(gj)
            packed = tsg.update_slab_pointers(packed)
            inner = tsg.update_slab_pointers(inner)


def test_free_list_drains_before_bump():
    """A pool whose free list the reference's maintenance filled: both
    engines place new slabs on recycled rows first."""
    rng = np.random.default_rng(3)
    V = 200
    src = np.concatenate([np.zeros(3 * 128, np.int64),
                          rng.integers(0, V, 400)])
    dst = np.concatenate([np.arange(1, 3 * 128 + 1) % V,
                          rng.integers(0, V, 400)])
    gj = jsg.from_edges_host(V, src, dst, hashing=False, slack_slabs=64)
    gj, _ = jbatch.delete_edges(gj, jids(src[:3 * 128]),
                                jids(dst[:3 * 128]), impl="jnp")
    gj, freed = reclaim_free_slabs(gj)
    assert int(gj.free_top) > 0 and freed > 0
    gt = to_port(gj)
    s = np.zeros(300, np.int64)
    d = rng.permutation(V)[:300 % V].tolist()
    d = np.asarray((d * 2)[:300])
    s[150:] = rng.integers(0, V, 150)
    gj, mj = jbatch.insert_edges(gj, jids(s, 512), jids(d, 512), impl="jnp")
    gt, mt = tbatch.insert_edges(gt, ids(s, 512), ids(d, 512))
    assert np.array_equal(np_of(mt), np_of(mj))
    assert_pools_equal(gt, gj, "recycled insert")


@pytest.mark.parametrize("with_symmetric", [False, True])
def test_update_views_masks_and_pools(with_symmetric):
    rng = np.random.default_rng(5)
    V = 40
    src = rng.integers(0, V, 120)
    dst = rng.integers(0, V, 120)
    roles = ("forward", "transpose") + (("symmetric",) if with_symmetric
                                        else ())

    def build(mod, **kw):
        views = [mod.from_edges_host(V, src, dst, hashing=False,
                                     slack_slabs=256, **kw),
                 mod.from_edges_host(V, dst, src, hashing=False,
                                     slack_slabs=256, **kw)]
        if with_symmetric:
            views.append(mod.from_edges_host(
                V, np.concatenate([src, dst]), np.concatenate([dst, src]),
                hashing=False, slack_slabs=256, **kw))
        return tuple(views)

    vj, vt = build(jsg), build(tsg, device="cpu")
    for step in range(3):
        i_s, i_d = rng.integers(0, V, 20), rng.integers(0, V, 20)
        d_s, d_d = src[step * 6:step * 6 + 6], dst[step * 6:step * 6 + 6]
        vj, imj, dmj = jbatch.update_views(
            vj, roles, ins=(jids(i_s, 32), jids(i_d, 32), None),
            dels=(jids(d_s, 8), jids(d_d, 8)))
        vt, imt, dmt = tbatch.update_views(
            vt, roles, ins=(ids(i_s, 32), ids(i_d, 32), None),
            dels=(ids(d_s, 8), ids(d_d, 8)))
        assert np.array_equal(np_of(imt), np_of(imj))
        assert np.array_equal(np_of(dmt), np_of(dmj))
        for name, a, b in zip(roles, vt, vj):
            assert_pools_equal(a, b, f"{name} epoch {step}")


def test_apply_update_and_sentinel_queries():
    g = tsg.empty(16, np.ones(16, np.int32), 64, device="cpu")
    gj = jsg.empty(16, np.ones(16, np.int32), 64)
    g, im, dm = tbatch.apply_update(g, ids([3, 3], 4), ids([5, 6], 4), None,
                                    ids([3], 4), ids([6], 4))
    gj, imj, dmj = jbatch.apply_update(gj, jids([3, 3], 4), jids([5, 6], 4),
                                       None, jids([3], 4), jids([6], 4),
                                       impl="jnp")
    assert np.array_equal(np_of(im), np_of(imj))
    assert np.array_equal(np_of(dm), np_of(dmj))
    assert_pools_equal(g, gj, "apply_update")
    q_src = ids([3, 3, 3, 3, 0x80000000, 0xFFFFFFFF, 16, 3])
    q_dst = ids([0xFFFFFFFE, 0xFFFFFFFD, 0xFFFFFFFF, 5, 5, 5, 5, 6])
    assert tbatch.query_edges(g, q_src, q_dst).tolist() == \
        [False, False, False, True, False, False, False, True]
    with pytest.raises(ValueError):
        tbatch.query_edges(g, q_src, q_dst, impl="cuda")


#: a hub's out-edges for the long-chain cases: about 313 slabs
HUB_EDGES = 40000


def _probe_pool(rng, V, pool):
    """(src, dst) of the probe cases: a 300-edge hub and random edges, or a
    hub of ``HUB_EDGES`` distinct out-edges beside them."""
    src = np.concatenate([np.zeros(300, np.int64), rng.integers(0, V, 500)])
    dst = np.concatenate([np.arange(300) % V + 0, rng.integers(0, V, 500)])
    if pool == "hub":
        src = np.concatenate([src, np.full(HUB_EDGES, 1)])
        dst = np.concatenate([dst, rng.choice(10 ** 6, HUB_EDGES,
                                              replace=False)])
    return src, dst


@pytest.mark.parametrize("layout", ["as built", "permuted"])
@pytest.mark.parametrize("pool", ["mixed", "hub"])
def test_plain_probe_and_commit_match_pallas_kernels(pool, layout):
    """The plain probe against the reference's kernel, bit for bit, on the
    pool as built (overflow runs of consecutive rows) and with its overflow
    rows relabelled (almost no link consecutive); then the commit."""
    rng = np.random.default_rng(11)
    V = 200
    src, dst = _probe_pool(rng, V, pool)
    gj = jsg.from_edges_host(V, src, dst, hashing=False, slack_slabs=64)
    keys, nxt = np.array(gj.keys), np.array(gj.next_slab)
    if layout == "permuted":
        keys, nxt, _ = permuted_rows(keys, nxt, np.asarray(gj.slab_vertex),
                                     gj.n_buckets, seed=5)
    B = 48
    start = rng.integers(-1, V, B).astype(np.int32)
    qd = np.where(rng.random(B) < 0.5, dst[rng.integers(0, len(dst), B)],
                  rng.integers(0, V, B)).astype(np.int64)
    if pool == "hub":
        # keys at spread positions of the hub's chain (its first and last
        # slab among them), and keys it does not hold
        at = np.linspace(800, len(dst) - 1, 24).astype(np.int64)
        start = np.concatenate([start, np.ones(32, np.int32)])
        qd = np.concatenate([qd, dst[at], 10 ** 6 + np.arange(8)])
    got = slab_probe(torch.from_numpy(keys.view(np.int32)),
                     torch.from_numpy(nxt), torch.from_numpy(start), ids(qd))
    want = slab_probe_pallas(jnp.asarray(keys), jnp.asarray(nxt),
                             jnp.asarray(start), jids(qd),
                             queries_per_tile=8, interpret=True)
    for a, b in zip(got, want):
        assert np.array_equal(np_of(a), np_of(b))
    if pool == "hub":
        assert bool(got[0][-32:-8].all()) and not bool(got[0][-8:].any())

    gt = to_port(gj)
    S = gt.capacity_slabs
    slots = rng.choice(S * 128, B, replace=False)
    e_slab = (slots // 128).astype(np.int32)
    e_slab[::5] = S                                     # parked lanes
    e_lane = (slots % 128).astype(np.int32)
    vals = rng.integers(0, V, B).astype(np.int64)
    deg_idx = rng.integers(0, V + 8, B).astype(np.int32)
    delta = rng.choice([-1, 1], B).astype(np.int32)
    wv = rng.uniform(0, 2, B).astype(np.float32)
    gw = jsg.from_edges_host(V, src, dst, np.ones(len(src), np.float32),
                             hashing=False, slack_slabs=64)
    kj, degj, wj = slab_commit_pallas(
        gw.keys, gw.degree, gw.weights, jnp.asarray(e_slab),
        jnp.asarray(e_lane), jids(vals), jnp.asarray(deg_idx),
        jnp.asarray(delta), jnp.asarray(wv), interpret=True)
    gtw = to_port(gw)
    slab_commit(gtw.keys, gtw.degree, gtw.weights, torch.from_numpy(e_slab),
                torch.from_numpy(e_lane), ids(vals),
                torch.from_numpy(deg_idx), torch.from_numpy(delta),
                torch.from_numpy(wv))
    assert np.array_equal(np_of(gtw.keys), np_of(kj))
    assert np.array_equal(np_of(gtw.degree), np_of(degj))
    assert np.array_equal(np_of(gtw.weights), np_of(wj))


def test_plain_commit_rejects_colliding_targets():
    g = tsg.empty(4, np.ones(4, np.int32), 8, device="cpu")
    two = torch.tensor([1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="same slot"):
        slab_commit_torch(g.keys, g.degree, None, two, two, two, two, two)
