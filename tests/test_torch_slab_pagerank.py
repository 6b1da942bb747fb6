"""Port parity: kernel 4's op surface (``kernels/slab_pagerank``) against
``repro.kernels.slab_pagerank`` on the CPU.

The reference's own test (``tests/test_kernels.py``) scatters EMPTY and
TOMBSTONE keys through its rows at random.  On those rows:

* ``ref.slab_contrib_sums_ref`` matches the reference's oracle and its
  Pallas kernel in interpret mode, within the reference test's
  atol 1e-4 / rtol 1e-5;
* the op and its kernel entry point refuse the rows: kernel 3 reads a row
  only up to its first EMPTY lane, so the card would sum fewer lanes than
  the reference.

On the same rows packed (the EMPTY lanes moved to the tail, the other lanes
kept in order) the op and the entry point match the reference's op and
oracle within the same tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slab_pagerank.kernel import slab_contrib_sums_pallas
from repro.kernels.slab_pagerank.ops import slab_contrib_sums as jop
from repro.kernels.slab_pagerank.ref import slab_contrib_sums_ref as jref
from repro_torch.kernels import runtime
from repro_torch.kernels.slab_pagerank import (slab_contrib_sums,
                                               slab_contrib_sums_cuda,
                                               slab_contrib_sums_ref,
                                               unpacked_rows)

CASES = [(16, 100, 8), (100, 1000, 32), (257, 50, 64), (512, 4096, 256)]
TOL = dict(atol=1e-4, rtol=1e-5)
EMPTY, TOMB = 0xFFFFFFFE, 0xFFFFFFFD


def _rows(S, V):
    """The reference test's rows, owners and contributions (seed 3)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, V, (S, 128)).astype(np.uint32)
    keys[rng.random((S, 128)) < 0.3] = EMPTY
    keys[rng.random((S, 128)) < 0.1] = TOMB
    owner = rng.integers(-1, 50, S).astype(np.int32)
    contrib = rng.standard_normal(V).astype(np.float32)
    return keys, owner, contrib


def _packed(keys):
    """Each row's EMPTY lanes moved to its tail, the others kept in order."""
    order = np.argsort(keys == EMPTY, axis=1, kind="stable")
    return np.take_along_axis(keys, order, axis=1)


def _t(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


@pytest.mark.parametrize("S,V,R", CASES)
def test_ref_matches_reference_on_unpacked_rows(S, V, R):
    keys, owner, contrib = _rows(S, V)
    assert unpacked_rows(_t(keys)) > 0
    got = slab_contrib_sums_ref(_t(keys), torch.from_numpy(owner),
                                torch.from_numpy(contrib), n_vertices=V)
    want = jref(jnp.asarray(keys), jnp.asarray(owner), jnp.asarray(contrib),
                n_vertices=V)
    pallas = slab_contrib_sums_pallas(jnp.asarray(keys), jnp.asarray(owner),
                                      jnp.asarray(contrib), n_vertices=V,
                                      rows_per_block=R, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (S,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("S,V,R", CASES)
def test_op_refuses_unpacked_rows(S, V, R):
    keys, owner, contrib = _rows(S, V)
    valid = torch.from_numpy((keys < V) & (owner[:, None] >= 0))
    before = dict(runtime.LAUNCHES)
    with pytest.raises(ValueError, match="after an EMPTY lane"):
        slab_contrib_sums(_t(keys), valid, torch.from_numpy(contrib))
    with pytest.raises(ValueError, match="after an EMPTY lane"):
        slab_contrib_sums_cuda(_t(keys), torch.from_numpy(owner),
                               torch.from_numpy(contrib), n_vertices=V)
    assert runtime.LAUNCHES == before


@pytest.mark.parametrize("S,V,R", CASES)
def test_op_matches_reference_on_packed_rows(S, V, R):
    keys, owner, contrib = _rows(S, V)
    keys = _packed(keys)
    assert unpacked_rows(_t(keys)) == 0
    valid = (keys < V) & (owner[:, None] >= 0)
    got = slab_contrib_sums(_t(keys), torch.from_numpy(valid),
                            torch.from_numpy(contrib))
    want = jop(jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(contrib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = slab_contrib_sums_cuda(_t(keys), torch.from_numpy(owner),
                                 torch.from_numpy(contrib), n_vertices=V)
    want = jref(jnp.asarray(keys), jnp.asarray(owner), jnp.asarray(contrib),
                n_vertices=V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unpacked_rows_counts_each_bad_row_once():
    keys = np.full((4, 128), EMPTY, np.uint32)
    keys[0, :5] = 1                      # packed
    keys[1, 3] = 2                       # a key after three EMPTY lanes
    keys[2, [0, 7, 9]] = [3, TOMB, 4]    # a tombstone after an EMPTY lane
    assert unpacked_rows(_t(keys)) == 2
    keys[3, :] = 5                       # full row: packed
    assert unpacked_rows(_t(keys)) == 2
