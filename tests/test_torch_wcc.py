"""Port parity: union-find and weakly connected components against the JAX
reference on the CPU.

Labels are the minimum vertex id of each component whatever order the
hooks land in, so every parent and label vector here must be bit-identical
to the reference's (no tolerance), as must the iteration counts of label
propagation.  The four incremental schemes (naive, batch, SlabIterator,
UpdateIterator) are each held to the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_vectors_equal, ids, jids, to_port

from repro import stream as jstream
from repro.algorithms import wcc as jwcc
from repro.core import (delete_edges, empty, ensure_capacity,
                        from_edges_host, insert_edges, update_slab_pointers)
from repro.core import union_find as juf
from repro.core.worklist import pool_edges, transpose_host
from repro_torch import stream as tstream
from repro_torch.algorithms import wcc as twcc
from repro_torch.algorithms import wcc_stream_property
from repro_torch.core import union_find as tuf
from repro_torch.core.worklist import pool_edges as tpool_edges


def _forest(rng, n):
    """A random parent forest (every parent id at most its child's)."""
    return (rng.random(n) * (np.arange(n) + 1)).astype(np.int32)


def _graph(seed, *, V=300, E=700, hashing=False):
    """A sparse reference graph after a delete and an insert epoch: several
    components, tombstones, an open then closed epoch."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E).astype(np.uint32)
    dst = rng.integers(0, V, E).astype(np.uint32)
    g = from_edges_host(V, src, dst, hashing=hashing, slack_slabs=64)
    g, _ = delete_edges(g, jnp.asarray(src[:120]), jnp.asarray(dst[:120]))
    ins = rng.integers(0, V, (64, 2)).astype(np.uint32)
    g, _ = insert_edges(g, jnp.asarray(ins[:, 0]), jnp.asarray(ins[:, 1]))
    return update_slab_pointers(g), rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_batch_and_compress_match(seed):
    rng = np.random.default_rng(seed)
    V, B = 400, 256
    parent = _forest(rng, V)
    assert_vectors_equal(tuf.compress(torch.from_numpy(parent)),
                         juf.compress(jnp.asarray(parent)), "compress")
    u = rng.integers(0, V, B).astype(np.int32)
    v = rng.integers(0, V, B).astype(np.int32)
    mask = rng.random(B) < 0.8
    want = juf.union_batch(jnp.asarray(parent), jnp.asarray(u),
                           jnp.asarray(v), jnp.asarray(mask))
    got = tuf.union_batch(torch.from_numpy(parent), torch.from_numpy(u),
                          torch.from_numpy(v), torch.from_numpy(mask))
    assert_vectors_equal(got, want, "union_batch")
    assert tuf.count_components(got) == int(juf.count_components(want))
    assert_vectors_equal(tuf.component_labels(got),
                         juf.component_labels(want), "labels")


@pytest.mark.parametrize("hashing", [False, True])
def test_wcc_static_and_naive_match(hashing):
    gj, rng = _graph(3, hashing=hashing)
    gt = to_port(gj)
    want = jwcc.wcc_static(gj)
    assert_vectors_equal(twcc.wcc_static(gt), want, "static")
    assert_vectors_equal(twcc.wcc_static(gt, cap=4096),
                         jwcc.wcc_static(gj, cap=4096), "static, cap")
    assert twcc.count_components(twcc.wcc_static(gt)) == \
        jwcc.count_components(want)
    parent = _forest(rng, gj.n_vertices)
    assert_vectors_equal(
        twcc.wcc_incremental_naive(torch.from_numpy(parent), gt),
        jwcc.wcc_incremental_naive(jnp.asarray(parent), gj), "naive")


@pytest.mark.parametrize("cap", [None, 100])
def test_compact_lanes_match(cap):
    """Pool order, and the reference's drop of lanes past ``cap``."""
    gj, _ = _graph(4)
    gt = to_port(gj)
    n = int(pool_edges(gj).valid.sum())
    jcap = cap or 1 << (n - 1).bit_length()
    want = jwcc._compact_lanes(gj, pool_edges(gj).valid, jcap)
    got = twcc._compact_lanes(gt, tpool_edges(gt).valid, cap)
    for name, a, b in zip(("u", "v", "mask"), got, want):
        assert_vectors_equal(a, b, name)
    assert_vectors_equal(twcc._union_pool(tuf.init_parents(300, "cpu"), gt,
                                          tpool_edges(gt).valid, cap=cap),
                         jwcc._union_pool(juf.init_parents(300), gj,
                                          pool_edges(gj).valid, cap=jcap),
                         "union over the pool")


def test_wcc_incremental_batch_matches():
    gj, rng = _graph(5)
    labels_j = jwcc.wcc_static(gj)
    labels_t = twcc.wcc_static(to_port(gj))
    B = 128
    s, d = rng.integers(0, 300, 100), rng.integers(0, 300, 100)
    mask = np.arange(B) < 100
    mask[::7] = False
    want = jwcc.wcc_incremental_batch(labels_j, jids(s, B), jids(d, B),
                                      jnp.asarray(mask))
    got = twcc.wcc_incremental_batch(labels_t, ids(s, B), ids(d, B),
                                     torch.from_numpy(mask))
    assert_vectors_equal(got, want, "batch")


@pytest.mark.parametrize("hashing", [False, True])
def test_labelprop_sweep_and_ref_match(hashing):
    gj, _ = _graph(6, hashing=hashing)
    sym_j = transpose_host(gj, symmetric=True, hashing=hashing)
    sym_t = to_port(sym_j)
    lab_j, it_j = jwcc.wcc_labelprop_sweep(sym_j)
    for fn in (twcc.wcc_labelprop_sweep, twcc.wcc_labelprop_ref):
        lab, it = fn(sym_t)
        assert_vectors_equal(lab, lab_j, fn.__name__)
        assert it == int(it_j)
    lab_r, it_r = jwcc.wcc_labelprop_ref(sym_j)
    assert_vectors_equal(lab_r, lab_j, "reference oracle")
    # label propagation and union-find agree on the components
    assert_vectors_equal(twcc.wcc_static(to_port(gj)), lab_j, "union-find")


@pytest.mark.parametrize("policy", ["lazy", "eager"])
def test_wcc_stream_property_matches(policy):
    rng = np.random.default_rng(7)
    V = 200
    src, dst = rng.integers(0, V, 300), rng.integers(0, V, 300)
    js = jstream.GraphStore.from_edges(V, src, dst, hashing=False,
                                       with_symmetric=False)
    ts = tstream.GraphStore.from_edges(V, src, dst, hashing=False,
                                       with_symmetric=False, device="cpu")
    jreg, treg = jstream.PropertyRegistry(js), tstream.PropertyRegistry(ts)
    jreg.register(jwcc.stream_property(), policy=policy)
    treg.register(wcc_stream_property(), policy=policy)
    assert_vectors_equal(treg.read("wcc"), jreg.read("wcc"), "init")
    epochs = [dict(ins=60, dels=0), dict(ins=40, dels=30),
              dict(ins=80, dels=0), dict(ins=0, dels=50),
              dict(ins=50, dels=0)]
    present = list(zip(src.tolist(), dst.tolist()))
    for i, ep in enumerate(epochs):
        ins = rng.integers(0, V, (ep["ins"], 2))
        dels = [present[k] for k in rng.choice(len(present), ep["dels"],
                                               replace=False)]
        kw = dict(ins_src=ins[:, 0], ins_dst=ins[:, 1]) if ep["ins"] else {}
        if dels:
            kw.update(del_src=[a for a, _ in dels],
                      del_dst=[b for _, b in dels])
        js.apply(**kw)
        ts.apply(**kw)
        present = [e for e in present if e not in set(dels)] + \
            list(map(tuple, ins.tolist()))
        assert_vectors_equal(treg.read("wcc"), jreg.read("wcc"),
                             f"epoch {i}")


def _open_epoch(seed, *, hashing):
    """A 64-vertex reference graph with an open insert epoch, and the
    labels of its graph before the batch.  Hashed, every eighth vertex has
    six buckets, past the SlabIterator scheme's default ``max_bpv`` of 4
    (the reference then skips its buckets past the fourth)."""
    rng = np.random.default_rng(seed)
    V = 64
    if hashing:
        g = empty(V, np.where(np.arange(V) % 8 == 0, 6, 2).astype(np.int32),
                  1024)
        g, _ = insert_edges(g, jids(rng.integers(0, V, 200), 256),
                            jids(rng.integers(0, V, 200), 256))
    else:
        g = from_edges_host(V, rng.integers(0, V, 120),
                            rng.integers(0, V, 120), hashing=False,
                            slack_slabs=64)
    g = update_slab_pointers(g)
    before = jwcc.wcc_static(g)
    g = ensure_capacity(g, 128)
    g, _ = insert_edges(g, jids(rng.integers(0, V, 48), 64),
                        jids(rng.integers(0, V, 48), 64))
    return g, before, rng


@pytest.mark.parametrize("hashing", [False, True])
def test_iterator_schemes_match(hashing):
    """The SlabIterator and UpdateIterator schemes from the pre-batch labels
    and from a random forest, with room for every edge and with bounds that
    drop some."""
    gj, before, rng = _open_epoch(8, hashing=hashing)
    gt = to_port(gj)
    forest = _forest(rng, gj.n_vertices)
    for parent in (np.asarray(before), forest):
        pj, pt = jnp.asarray(parent), torch.from_numpy(np.array(parent))
        for cap in (1024, 40):
            assert_vectors_equal(
                twcc.wcc_incremental_slab_iterator(pt, gt, cap=cap),
                jwcc.wcc_incremental_slab_iterator(pj, gj, cap=cap),
                f"slab_iterator, cap={cap}")
        for cap, mb in ((128, 0), (16, 0), (128, 5)):
            assert_vectors_equal(
                twcc.wcc_incremental_update_iterator(pt, gt, cap=cap,
                                                     max_buckets=mb),
                jwcc.wcc_incremental_update_iterator(pj, gj, cap=cap,
                                                     max_buckets=mb),
                f"update_iterator, cap={cap}, max_buckets={mb}")
    if not hashing:
        # unhashed, every scheme with room gives the static labels
        pt = torch.from_numpy(np.array(before))
        want = twcc.wcc_static(gt)
        for got in (twcc.wcc_incremental_slab_iterator(pt, gt, cap=1024),
                    twcc.wcc_incremental_update_iterator(pt, gt, cap=128),
                    twcc.wcc_incremental_naive(pt, gt)):
            assert torch.equal(got, want)
