"""Port parity: the iterator API, the worklist functions of an open epoch
and the frontier queue against the JAX reference on the CPU.

Every input comes from a seed through numpy and is fed to both packages;
every output is integer or boolean (or float32 copied, never computed), so
each must be bit-identical: lane masks, ``EdgeFrontier`` fields as bit
patterns, ``CSR`` fields, iterator buffers and counts, transposed pools leaf
for leaf, and ``occupancy_stats`` dicts equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_pools_equal, jids, np_of, to_port

from repro.core import frontier as jfr
from repro.core import iterators as jit_
from repro.core import worklist as jwl
from repro.core.batch import delete_edges, insert_edges
from repro.core.slab_graph import (empty, ensure_capacity, from_edges_host,
                                   update_slab_pointers)
from repro.kernels.slab_compact import reclaim_free_slabs
from repro_torch.core import frontier as tfr
from repro_torch.core import iterators as tit
from repro_torch.core import worklist as twl

V = 64
HUB = 300            # the hub's edges: three slabs of one chain unhashed
B = 256              # every insert batch is padded to this many lanes


def _same(got, want, what=""):
    a, b = np_of(got), np_of(want)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} {b.shape}"
    assert np.array_equal(a, b), what


def _same_tuple(got, want, what=""):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, f"{what}[{i}]"
        else:
            _same(a, b, f"{what}[{i}]")


def _open_epoch(seed, *, hashing, weighted, recycle):
    """A reference graph with an open insert epoch: a hub (vertex 0) whose
    out-keys are ids past V (keys like any other), random edges, then one
    insert batch that lengthens the hub's chain.  With ``recycle`` the
    hub's middle slab is emptied and reclaimed first, so the batch's new
    slab comes off the free list, below ``epoch_next_free``."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(HUB, np.int64), rng.integers(0, V, 200)])
    dst = np.concatenate([100 + np.arange(HUB), rng.integers(0, V, 200)])
    w = rng.uniform(0, 1, len(src)).astype(np.float32) if weighted else None
    g = from_edges_host(V, src, dst, w, hashing=hashing, slack_slabs=64)
    if recycle:
        mid = 100 + np.arange(128, 256)       # the hub's first overflow slab
        g, _ = delete_edges(update_slab_pointers(g),
                            jids(np.zeros(128, np.int64)), jids(mid))
        g, n = reclaim_free_slabs(update_slab_pointers(g))
        assert n == 1 and int(g.free_top) == 1
    g = ensure_capacity(update_slab_pointers(g), B + 64)
    s = np.concatenate([np.zeros(150, np.int64), rng.integers(0, V, 60)])
    d = np.concatenate([1000 + np.arange(150), rng.integers(0, V, 60)])
    bw = (jnp.asarray(rng.uniform(0, 1, B).astype(np.float32))
          if weighted else None)
    g, _ = insert_edges(g, jids(s, B), jids(d, B), bw)
    return g, to_port(g)


#: hashed, the hub's 300 keys spread over four one-slab buckets, so only
#: the unhashed pools have an overflow slab to recycle
CASES = [dict(hashing=False, weighted=False, recycle=True),
         dict(hashing=False, weighted=True, recycle=True),
         dict(hashing=False, weighted=False, recycle=False),
         dict(hashing=True, weighted=False, recycle=False),
         dict(hashing=True, weighted=True, recycle=False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    k for k, v in c.items() if v) or "plain")
def test_worklist_of_open_epoch_matches(case):
    gj, gt = _open_epoch(11, **case)
    if case["recycle"]:
        # the recycled slab is new this epoch but below the watermark
        new_rows = np.nonzero(np.asarray(gj.slab_new))[0]
        assert (new_rows < int(gj.epoch_next_free)).any()
    _same(twl.updated_lane_mask(gt), jwl.updated_lane_mask(gj), "lane mask")
    _same(twl.updated_vertices(gt), jwl.updated_vertices(gj), "vertices")
    for mb, cap in ((256, 512), (3, 512), (256, 100)):
        _same_tuple(twl.updated_edges(gt, max_buckets=mb, out_capacity=cap),
                    jwl.updated_edges(gj, max_buckets=mb, out_capacity=cap),
                    f"updated_edges({mb}, {cap})")
    for max_edges in (1 << 20, 300):
        _same_tuple(twl.csr_snapshot(gt, max_edges=max_edges),
                    jwl.csr_snapshot(gj, max_edges=max_edges),
                    f"csr_snapshot({max_edges})")
    assert twl.occupancy_stats(gt) == jwl.occupancy_stats(gj)
    assert gt.nbytes() == gj.nbytes()


def test_updated_edges_overflow_flag_matches():
    """More new edges than ``out_capacity``: size stops there and the flag
    is set, in both packages."""
    gj, gt = _open_epoch(12, hashing=False, weighted=False, recycle=False)
    got = twl.updated_edges(gt, max_buckets=64, out_capacity=64)
    want = jwl.updated_edges(gj, max_buckets=64, out_capacity=64)
    _same_tuple(got, want, "overflowing updated_edges")
    assert bool(got.overflow) and int(got.size) == 64


@pytest.mark.parametrize("hashing", [False, True])
def test_transpose_host_matches(hashing):
    rng = np.random.default_rng(13)
    src, dst = rng.integers(0, V, 400), rng.integers(0, V, 400)
    w = rng.uniform(0, 1, 400).astype(np.float32)
    gj = from_edges_host(V, src, dst, w, hashing=hashing)
    gt = to_port(gj)
    for sym in (False, True):
        kw = dict(symmetric=sym, hashing=hashing, slack_slabs=8)
        assert_pools_equal(twl.transpose_host(gt, device="cpu", **kw),
                           jwl.transpose_host(gj, **kw),
                           f"transpose, symmetric={sym}")


def _hashed_epoch():
    """Two buckets a vertex and a hub spread over both: the iterators'
    bucket walks, truncation and the reference's walks past a vertex's last
    bucket."""
    rng = np.random.default_rng(14)
    g = empty(V, np.full(V, 2, np.int32), 512)
    s = np.concatenate([np.zeros(200, np.int64), rng.integers(0, V, 56)])
    d = np.concatenate([100 + np.arange(200), rng.integers(0, V, 56)])
    g, _ = insert_edges(g, jids(s, B), jids(d, B))
    g = ensure_capacity(update_slab_pointers(g), B + 64)
    s = np.concatenate([np.zeros(40, np.int64), rng.integers(0, V, 40)])
    d = np.concatenate([400 + np.arange(40), rng.integers(0, V, 40)])
    g, _ = insert_edges(g, jids(s, B), jids(d, B))
    return g, to_port(g)


@pytest.mark.parametrize("max_neighbors", [512, 150, 100])
def test_iterators_match(max_neighbors):
    """Each iterator on the hub, on vertices with and without new edges and
    on the last vertex (whose walks past its buckets the reference masks).
    The hub has over 240 neighbours in two buckets of 100-150: at 150 the cut
    falls inside its second bucket, at 100 inside a bucket's own count."""
    gj, gt = _hashed_epoch()
    degree = np.asarray(gj.degree)
    per_bucket = [int(jit_.bucket_iterator(gj, jnp.int32(0), jnp.int32(i),
                                           max_neighbors=512)[1])
                  for i in range(2)]
    assert int(gj.bucket_count[0]) == 2 and degree[0] >= 240
    assert min(per_bucket) < 150 and max(per_bucket) > 100
    for v in (0, 1, 17, V - 1):
        for i in range(int(gj.bucket_count[v])):
            _same_tuple(tit.bucket_iterator(gt, v, i,
                                            max_neighbors=max_neighbors),
                        jit_.bucket_iterator(gj, jnp.int32(v), jnp.int32(i),
                                             max_neighbors=max_neighbors),
                        f"bucket_iterator({v}, {i})")
        for bpv in (1, 2, 3):
            got = tit.slab_iterator(gt, v, max_neighbors=max_neighbors,
                                    max_bpv=bpv)
            _same_tuple(got, jit_.slab_iterator(
                gj, jnp.int32(v), max_neighbors=max_neighbors, max_bpv=bpv),
                f"slab_iterator({v}, max_bpv={bpv})")
        _same_tuple(tit.update_iterator(gt, v, max_neighbors=max_neighbors),
                    jit_.update_iterator(gj, jnp.int32(v),
                                         max_neighbors=max_neighbors),
                    f"update_iterator({v})")
    n_hub = int(tit.slab_iterator(gt, 0, max_neighbors=max_neighbors,
                                  max_bpv=2)[1])
    assert n_hub == min(int(degree[0]), max_neighbors)


def test_iterators_on_recycled_chain_match():
    """The unhashed hub's chain of four slabs, one of them recycled."""
    gj, gt = _open_epoch(15, hashing=False, weighted=False, recycle=True)
    for mn in (1024, 200):
        _same_tuple(tit.slab_iterator(gt, 0, max_neighbors=mn),
                    jit_.slab_iterator(gj, jnp.int32(0), max_neighbors=mn),
                    f"slab_iterator(hub, {mn})")
        _same_tuple(tit.update_iterator(gt, 0, max_neighbors=mn),
                    jit_.update_iterator(gj, jnp.int32(0), max_neighbors=mn),
                    f"update_iterator(hub, {mn})")


def test_frontier_enqueue_overflow_swap_match():
    rng = np.random.default_rng(16)
    cap = 12
    ft = tfr.make_frontier(cap, 3, torch.float32, device="cpu")
    fj = jfr.make_frontier(cap, 3, jnp.float32)
    for step in range(4):
        vals = rng.uniform(-5, 5, (6, 3)).astype(np.float32)
        mask = rng.random(6) < 0.7
        before = ft.data.clone()
        ft2 = tfr.enqueue(ft, torch.from_numpy(vals), torch.from_numpy(mask))
        assert torch.equal(ft.data, before), "enqueue changed its argument"
        ft, fj = ft2, jfr.enqueue(fj, jnp.asarray(vals), jnp.asarray(mask))
        for name in ("data", "size", "overflow"):
            _same(getattr(ft, name), getattr(fj, name), f"{name} @{step}")
    assert bool(ft.overflow) and int(ft.size) == cap
    other_t = tfr.enqueue(tfr.make_frontier(cap, 3, device="cpu"),
                          torch.ones(2, 3), torch.ones(2, dtype=torch.bool))
    other_j = jfr.enqueue(jfr.make_frontier(cap, 3), jnp.ones((2, 3)),
                          jnp.ones(2, bool))
    for a, b in zip(tfr.swap(ft, other_t), jfr.swap(fj, other_j)):
        for name in ("data", "size", "overflow"):
            _same(getattr(a, name), getattr(b, name), f"swap: {name}")
    cleared = tfr.clear(ft)
    assert int(cleared.size) == 0 and not bool(cleared.overflow)
