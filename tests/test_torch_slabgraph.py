"""Port parity: slab layout and construction, the numpy bridge, the bucket
hash and the synthetic data against the JAX reference (on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, assert_pools_equal, jax_fields, to_port

from repro.core import hashing as jhash
from repro.core import slab_graph as jsg
from repro.data.synth import rmat_edges as jax_rmat
from repro.kernels.slab_compact import reclaim_free_slabs
from repro_torch.core import hashing as thash
from repro_torch.core import slab_graph as tsg
from repro_torch.core.bridge import slab_graph_from_numpy, \
    slab_graph_to_numpy
from repro_torch.core.device import resolve_device, resolve_impl
from repro_torch.data.synth import rmat_edges as torch_rmat


def _edges(case):
    """The edge lists of tests/test_core_slabgraph.py and the overflow
    chains of tests/test_slab_update.py."""
    if case == "overflow":
        n0, n1 = 3 * 128 + 11, 128 + 2
        src = np.asarray([0] * n0 + [1] * n1 + [2], np.uint32)
        dst = np.asarray(list(range(1, n0 + 1)) + list(range(2, n1 + 2))
                         + [7], np.uint32)
        return 600, src, dst
    seed, V, E = {"rand40": (1, 40, 500), "rand50": (0, 50, 300),
                  "rand1000": (2, 1000, 3000)}[case]
    rng = np.random.default_rng(seed)
    return (V, rng.integers(0, V, E).astype(np.uint32),
            rng.integers(0, V, E).astype(np.uint32))


@pytest.mark.parametrize("case", ["rand40", "rand50", "rand1000",
                                  "overflow"])
@pytest.mark.parametrize("hashing", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_from_edges_host_leaf_identical(case, hashing, weighted):
    V, src, dst = _edges(case)
    w = (np.random.default_rng(3).uniform(0.1, 4.0, len(src))
         .astype(np.float32) if weighted else None)
    gj = jsg.from_edges_host(V, src, dst, w, hashing=hashing,
                             slack_slabs=17)
    gt = tsg.from_edges_host(V, src, dst, w, hashing=hashing,
                             slack_slabs=17, device="cpu")
    assert_pools_equal(gt, gj, case)


@pytest.mark.parametrize("hashing", [True, False])
def test_empty_grow_and_close_match(hashing):
    V = 32
    bc = jsg.plan_buckets(V, np.arange(V) * 40, hashing=hashing)
    assert np.array_equal(bc, tsg.plan_buckets(V, np.arange(V) * 40,
                                               hashing=hashing))
    gj = jsg.empty(V, bc, 70, weighted=True)
    gt = tsg.empty(V, bc, 70, weighted=True, device="cpu")
    assert_pools_equal(gt, gj, "empty")
    assert_pools_equal(tsg.ensure_capacity(gt, 300),
                       jsg.ensure_capacity(gj, 300), "grown")
    assert_pools_equal(tsg.update_slab_pointers(gt),
                       jsg.update_slab_pointers(gj), "closed")
    assert tsg.next_pow2(70) == jsg.next_pow2(70) == 128


def _empty_host(V, bucket_count, capacity, weighted):
    """The fields of an empty pool, filled on the host with numpy."""
    offset = np.zeros(V + 1, np.int32)
    np.cumsum(bucket_count, out=offset[1:])
    nb = int(offset[-1])
    S = max(capacity, nb + 1)
    bucket_vertex = np.repeat(np.arange(V, dtype=np.int32), bucket_count)
    slab_vertex = np.full(S, -1, np.int32)
    slab_vertex[:nb] = bucket_vertex
    return dict(
        keys=np.full((S, 128), -2, np.int32),
        weights=np.zeros((S, 128), np.float32) if weighted else None,
        next_slab=np.full(S, -1, np.int32), slab_vertex=slab_vertex,
        bucket_offset=offset, bucket_count=bucket_count,
        bucket_vertex=bucket_vertex, tail_slab=np.arange(nb, dtype=np.int32),
        tail_fill=np.zeros(nb, np.int32), upd_flag=np.zeros(nb, bool),
        upd_slab=np.arange(nb, dtype=np.int32),
        upd_lane=np.zeros(nb, np.int32), next_free=np.int32(nb),
        epoch_next_free=np.int32(nb), free_list=np.full(S, -1, np.int32),
        free_top=np.int32(0), slab_new=np.zeros(S, bool),
        degree=np.zeros(V, np.int32), n_edges=np.int32(0))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("counts", ["ones", "planned", "zeros"])
def test_empty_device_build_matches_host_build(counts, weighted):
    """``empty`` fills the pool with tensor ops on the target device; it is
    leaf-identical to the same pool filled with numpy on the host."""
    V = 37
    bc = {"ones": np.ones(V, np.int32),
          "planned": tsg.plan_buckets(V, np.arange(V) * 30),
          "zeros": np.where(np.arange(V) % 5 == 0, 0, 2).astype(np.int32)
          }[counts]
    for cap in (8, 300):
        host = slab_graph_from_numpy(_empty_host(V, bc, cap, weighted), CPU)
        got = tsg.empty(V, bc, cap, weighted=weighted, device="cpu")
        assert (got.n_vertices, got.n_buckets, got.weighted) == (
            host.n_vertices, host.n_buckets, host.weighted)
        for name in tsg.FIELDS:
            a, b = getattr(got, name), getattr(host, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), name
    before = got.bucket_count.clone()
    bc += 1                          # the graph keeps no view of the input
    assert torch.equal(got.bucket_count, before)


def test_update_slab_pointers_breaks_aliases():
    g = tsg.update_slab_pointers(tsg.empty(4, np.ones(4, np.int32), 16,
                                           device="cpu"))
    g.tail_slab[0] = 9
    g.next_free.fill_(3)
    assert int(g.upd_slab[0]) == 0 and int(g.epoch_next_free) == 4


def test_bridge_round_trip_and_pool_stats():
    V, src, dst = _edges("rand1000")
    gj = jsg.from_edges_host(V, src, dst, hashing=True)
    # a pool with a non-empty free list, from the reference's maintenance
    gj, _ = reclaim_free_slabs(gj)
    fields = jax_fields(gj)
    back = slab_graph_to_numpy(slab_graph_from_numpy(fields, CPU))
    for name, a in fields.items():
        assert np.array_equal(back[name], a), name
    # uint32 keys are viewed, not converted
    raw = dict(fields, keys=np.asarray(gj.keys))
    assert_pools_equal(slab_graph_from_numpy(raw, "cpu"), gj, "uint32 in")
    assert tsg.pool_stats(to_port(gj)) == jsg.pool_stats(gj)


def test_bucket_hash_bit_identical():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    d[:5] = [0xFFFFFFFE, 0xFFFFFFFD, 0xFFFFFFFF, 0x80000000, 0]
    nb = rng.integers(1, 2 ** 20, 4096).astype(np.int32)
    nb[:8] = 1
    want = np.asarray(jhash.bucket_hash(jnp.asarray(d), jnp.asarray(nb)))
    got = thash.bucket_hash(torch.from_numpy(d.view(np.int32).copy()),
                            torch.from_numpy(nb)).numpy()
    assert np.array_equal(got, want)
    valid_want = np.asarray(jhash.is_valid_vertex(jnp.asarray(d)))
    valid_got = thash.is_valid_vertex(
        torch.from_numpy(d.view(np.int32).copy())).numpy()
    assert np.array_equal(valid_got, valid_want)


def test_rmat_edges_identical():
    for V, E, seed in ((1000, 5000, 0), (4096, 20000, 7)):
        for a, b in zip(jax_rmat(V, E, seed=seed),
                        torch_rmat(V, E, seed=seed)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: resolving cuda succeeds")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tsg.from_edges_host(4, [0], [1], device="cuda")
    # the builders default to the card, as the store does
    with pytest.raises(RuntimeError, match="cuda"):
        tsg.from_edges_host(4, [0], [1])
    with pytest.raises(RuntimeError, match="cuda"):
        tsg.empty(4, np.ones(4, np.int32), 16)
    with pytest.raises(ValueError):
        resolve_impl("cuda", torch.zeros(1))
    assert resolve_impl("auto", torch.zeros(1)) == "torch"
