"""Port parity: the whole-pool update oracles (``query_edges_ref``,
``insert_edges_ref``, ``delete_edges_ref``, ``sort_by_bucket``) against the
reference's oracles and against the port's own engine, on the CPU.

As in the reference's own engine test, mixed insert / delete / query steps
run on three threaded states, the reference oracle's, the port oracle's and
the port engine's, and all three pools must stay equal leaf for leaf after
every step; the oracles must leave the graph they are given as it was.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_pools_equal, ids, jids, np_of, to_port

from repro.core import slab_graph as jsg
from repro.kernels.slab_compact import reclaim_free_slabs as jreclaim
from repro.kernels.slab_update import ref as jref
from repro_torch.core import batch as tbatch
from repro_torch.core import slab_graph as tsg
from repro_torch.core.bridge import slab_graph_to_numpy
from repro_torch.kernels.slab_compact import reclaim_free_slabs as treclaim
from repro_torch.kernels.slab_update import ref as tref


def _snapshot(g):
    return {k: None if v is None else v.copy()
            for k, v in slab_graph_to_numpy(g).items()}


def _assert_same_graph(a, b, what):
    fa, fb = slab_graph_to_numpy(a), slab_graph_to_numpy(b)
    for name in tsg.FIELDS:
        if fb[name] is None:
            assert fa[name] is None, f"{what}: {name}"
        else:
            assert np.array_equal(fa[name], fb[name]), f"{what}: {name}"


def _assert_unchanged(g, before, what):
    after = slab_graph_to_numpy(g)
    for name, a in before.items():
        assert (a is None and after[name] is None) or \
            np.array_equal(a, after[name]), f"{what} changed its {name}"


class Trio:
    """The reference oracle's, the port oracle's and the port engine's
    graphs, stepped together and compared after every step."""

    def __init__(self, gj):
        self.j, self.o, self.e = gj, to_port(gj), to_port(gj)

    def check(self, what):
        assert_pools_equal(self.o, self.j, f"{what}: oracle vs reference")
        _assert_same_graph(self.e, self.o, f"{what}: engine vs oracle")

    def insert(self, s, d, B, w=None, what=""):
        before = _snapshot(self.o)
        self.j, mj = jref.insert_edges_ref(
            self.j, jids(s, B), jids(d, B),
            None if w is None else jnp.asarray(w))
        tw = None if w is None else torch.from_numpy(w)
        o2, mo = tref.insert_edges_ref(self.o, ids(s, B), ids(d, B), tw)
        _assert_unchanged(self.o, before, "insert_edges_ref")
        self.o = o2
        self.e, me = tbatch.insert_edges(self.e, ids(s, B), ids(d, B), tw)
        assert np.array_equal(np_of(mo), np_of(mj)), f"{what}: mask"
        assert np.array_equal(np_of(me), np_of(mo)), f"{what}: engine mask"
        self.check(what)

    def delete(self, s, d, B, what=""):
        before = _snapshot(self.o)
        self.j, mj = jref.delete_edges_ref(self.j, jids(s, B), jids(d, B))
        o2, mo = tref.delete_edges_ref(self.o, ids(s, B), ids(d, B))
        _assert_unchanged(self.o, before, "delete_edges_ref")
        self.o = o2
        self.e, me = tbatch.delete_edges(self.e, ids(s, B), ids(d, B))
        assert np.array_equal(np_of(mo), np_of(mj)), f"{what}: mask"
        assert np.array_equal(np_of(me), np_of(mo)), f"{what}: engine mask"
        self.check(what)

    def query(self, s, d, B, what=""):
        qj = jref.query_edges_ref(self.j, jids(s, B), jids(d, B))
        qo = tref.query_edges_ref(self.o, ids(s, B), ids(d, B))
        qe = tbatch.query_edges(self.e, ids(s, B), ids(d, B))
        assert np.array_equal(np_of(qo), np_of(qj)), f"{what}: query"
        assert np.array_equal(np_of(qe), np_of(qo)), f"{what}: engine query"

    def close(self):
        self.j = jsg.update_slab_pointers(self.j)
        self.o = tsg.update_slab_pointers(self.o)
        self.e = tsg.update_slab_pointers(self.e)

    def reclaim(self):
        self.j, n = jreclaim(self.j)
        self.o, no = treclaim(self.o)
        self.e, ne = treclaim(self.e)
        assert n == no == ne
        self.check("reclaim")
        return n


@pytest.mark.parametrize("weighted", [False, True])
def test_oracles_match_over_mixed_steps(weighted):
    """Random inserts, deletes (hits and misses) and queries on two buckets
    a vertex; an epoch closes every third step."""
    rng = np.random.default_rng(21 + weighted)
    V, B = 24, 16
    trio = Trio(jsg.empty(V, np.full(V, 2, np.int32), 512,
                          weighted=weighted))
    for step in range(10):
        s, d = rng.integers(0, V, B), rng.integers(0, V, B)
        w = rng.uniform(0, 4, B).astype(np.float32) if weighted else None
        trio.insert(s, d, B, w, f"insert {step}")
        trio.delete(rng.integers(0, V, 8), rng.integers(0, V, 8), 8,
                    f"delete {step}")
        trio.query(s, d, B, f"query {step}")
        if step % 3 == 2:
            trio.close()


@pytest.mark.parametrize("hashing", [False, True])
def test_oracles_match_on_chains_and_recycled_slabs(hashing):
    """A hub's chain of several slabs (keys past V), a delete that empties
    its overflow slabs, a reclamation that puts them on the free list, and
    inserts that take them back below ``epoch_next_free``; ids at or past
    2**31 and sentinel keys ride along as invalid or absent lanes."""
    rng = np.random.default_rng(23)
    V, B = 64, 512
    src = np.concatenate([np.zeros(300, np.int64), rng.integers(0, V, 100)])
    dst = np.concatenate([100 + np.arange(300), rng.integers(0, V, 100)])
    trio = Trio(jsg.from_edges_host(V, src, dst, hashing=hashing,
                                    slack_slabs=64))
    trio.close()
    # the hub's keys 228..355: its first overflow slab when unhashed
    trio.delete(np.zeros(128, np.int64), 100 + np.arange(128, 256), B,
                "empty a slab")
    trio.close()
    freed = trio.reclaim()
    assert freed == (0 if hashing else 1)
    trio.close()
    s = np.concatenate([np.zeros(260, np.int64), rng.integers(0, V, 60),
                        [3, 4, 5]])
    d = np.concatenate([2000 + np.arange(260), rng.integers(0, V, 60),
                        [2 ** 31 + 7, 0xFFFFFFFE, 0xFFFFFFFD]])
    trio.insert(s, d, B, what="insert over the free list")
    if not hashing:
        new_rows = np.nonzero(np.asarray(trio.j.slab_new))[0]
        assert (new_rows < int(trio.j.epoch_next_free)).any()
    trio.query(s, d, B, "query")
    trio.delete(s[::3], d[::3], B, "delete a third")
    trio.query(s, d, B, "query after delete")


def test_sort_by_bucket_matches():
    """The reference sorts dst as its int32 bit pattern: keys at or past
    2**31 sort first, not last."""
    rng = np.random.default_rng(24)
    n = 64
    b = rng.integers(0, 6, n).astype(np.int32)
    dst = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    b[::5], dst[::5] = b[1::5], dst[1::5]     # ties on (bucket, dst)
    valid = rng.random(n) < 0.8
    oj, kj = jref.sort_by_bucket(jnp.asarray(b), jnp.asarray(dst),
                                 jnp.asarray(valid))
    ot, kt = tref.sort_by_bucket(torch.from_numpy(b),
                                 torch.from_numpy(dst.view(np.int32)),
                                 torch.from_numpy(valid))
    assert np.array_equal(ot.numpy(), np.asarray(oj).astype(np.int64))
    assert np.array_equal(kt.numpy(), np.asarray(kj))
