"""Port parity: the semiring slab sweep against the JAX reference's Pallas
kernel (interpret mode) on the CPU.

Tolerance: the min family (``min``, ``min_plus``, ``arg_min_plus``) must be
bit-identical.  A float ``sum`` may add the 128 lanes of a row in another
order than XLA's reduction, so it is held to float32 rounding of the row
total: ``rtol=1e-6`` plus ``atol=1e-6`` times the row's absolute sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_of, to_port

from repro.core import batch as jbatch
from repro.core import slab_graph as jsg
from repro.kernels.slab_sweep.ops import sweep_partials as jax_partials
from repro.kernels.slab_pagerank.kernel import slab_contrib_sums_pallas
from repro.kernels.slab_sweep.ops import sweep_vertices as jax_vertices
from repro_torch.kernels.slab_sweep import (SEMIRINGS, sweep_partials,
                                            sweep_vertices)

SUM_RTOL = 1e-6


def _pad(a, n):
    out = np.full(n, 0xFFFFFFFF, np.uint32)
    out[:len(a)] = a
    return jnp.asarray(out)


def _dynamic_graph(seed, weighted):
    """A churned pool: tombstones, a hub's overflow chain, an open epoch."""
    rng = np.random.default_rng(seed)
    V = 150
    src = np.concatenate([np.full(160, seed % V), rng.integers(0, V, 300)])
    dst = np.concatenate([rng.choice(V, 160, replace=False) if V >= 160
                          else rng.integers(0, V, 160),
                          rng.integers(0, V, 300)])
    w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32) if weighted \
        else None
    g = jsg.from_edges_host(V, src, dst, w, hashing=bool(seed % 2),
                            slack_slabs=32)
    g, _ = jbatch.delete_edges(g, _pad(src[:40], 64), _pad(dst[:40], 64),
                               impl="jnp")
    g = jsg.update_slab_pointers(g)
    s2, d2 = rng.integers(0, V, 50), rng.integers(0, V, 50)
    g, _ = jbatch.insert_edges(
        g, _pad(s2, 64), _pad(d2, 64),
        jnp.asarray(np.pad(rng.uniform(0.1, 2, 50), (0, 14)).astype(
            np.float32)) if weighted else None, impl="jnp")
    return g, rng


def _assert_close(semiring, got, want):
    got, want = np_of(got), np_of(want)
    assert got.dtype == want.dtype
    if semiring == "sum" and got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL,
                                   atol=SUM_RTOL * np.abs(want).max())
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("weighted", [False, True])
def test_sweep_partials_match_pallas(semiring, weighted):
    gj, rng = _dynamic_graph(3 if weighted else 4, weighted)
    gt = to_port(gj)
    V = gj.n_vertices
    values = rng.uniform(0, 5, V).astype(np.float32)
    values[rng.integers(0, V, 10)] = 1e30                 # unreached
    frontier = rng.random(V) < 0.4
    target = np.array(jax_vertices(gj, jnp.asarray(values),
                                   semiring="min_plus", impl="ref"))
    rows = int(gj.next_free) + 3
    for use_frontier in (False, True):
        for use_rows in (False, True):
            kw = dict(semiring=semiring,
                      weighted=True if (weighted and semiring == "sum")
                      else None,
                      rows=rows if use_rows else None)
            want = jax_partials(
                gj, jnp.asarray(values),
                frontier=jnp.asarray(frontier) if use_frontier else None,
                target=(jnp.asarray(target) if semiring == "arg_min_plus"
                        else None),
                impl="pallas", interpret=True, rows_per_block=1, **kw)
            got = sweep_partials(
                gt, torch.from_numpy(values),
                frontier=torch.from_numpy(frontier) if use_frontier
                else None,
                target=(torch.from_numpy(target)
                        if semiring == "arg_min_plus" else None), **kw)
            _assert_close(semiring, got, want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_sweep_vertices_match_reference(semiring):
    gj, rng = _dynamic_graph(5, weighted=False)
    gt = to_port(gj)
    V = gj.n_vertices
    values = rng.uniform(0, 5, V).astype(np.float32)
    frontier = rng.random(V) < 0.5
    target = np.array(jax_vertices(gj, jnp.asarray(values),
                                   semiring="min_plus",
                                   frontier=jnp.asarray(frontier)))
    tgt_kw = semiring == "arg_min_plus"
    want = jax_vertices(gj, jnp.asarray(values), semiring=semiring,
                        frontier=jnp.asarray(frontier),
                        target=jnp.asarray(target) if tgt_kw else None)
    got = sweep_vertices(gt, torch.from_numpy(values), semiring=semiring,
                         frontier=torch.from_numpy(frontier),
                         target=torch.from_numpy(target) if tgt_kw else None)
    _assert_close(semiring, got, want)


@pytest.mark.parametrize("semiring", ["sum", "min", "min_plus"])
def test_int32_values(semiring):
    """WCC-style int32 labels and BFS-vanilla frontier counts."""
    gj, rng = _dynamic_graph(6, weighted=False)
    gt = to_port(gj)
    labels = rng.permutation(gj.n_vertices).astype(np.int32)
    want = jax_partials(gj, jnp.asarray(labels), semiring=semiring,
                        impl="pallas", interpret=True, rows_per_block=8)
    got = sweep_partials(gt, torch.from_numpy(labels), semiring=semiring)
    _assert_close(semiring, got, want)


def test_pagerank_sums_match_contrib_kernel():
    """PageRank's contribution sums: the ``sum`` sweep with no frontier is
    the port's counterpart of the reference's ``slab_contrib_sums_pallas``."""
    gj, rng = _dynamic_graph(7, weighted=False)
    gt = to_port(gj)
    contrib = rng.uniform(0, 1, gj.n_vertices).astype(np.float32)
    want = slab_contrib_sums_pallas(gj.keys, gj.slab_vertex,
                                    jnp.asarray(contrib),
                                    n_vertices=gj.n_vertices,
                                    rows_per_block=8, interpret=True)
    got = sweep_partials(gt, torch.from_numpy(contrib), semiring="sum")
    _assert_close("sum", got, want)
