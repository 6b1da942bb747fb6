"""Port parity: kernel 4 (``kernels/slab_pagerank``) against
``repro.kernels.slab_pagerank`` on the CPU.

The reference's own test (``tests/test_kernels.py``) scatters EMPTY and
TOMBSTONE keys through its rows at random, so most rows hold keys after an
EMPTY lane.  The reference sums every lane whose key is a vertex, wherever
it sits, and so does the port's kernel (``csrc/slab_pagerank.cu``).  On
those rows, on the same rows packed (the EMPTY lanes moved to the tail) and
on hand-built rows (a TOMBSTONE after an EMPTY lane, a key >= V, an
allocated row of EMPTY lanes only, a full row, an unowned row holding keys)
the plain version, the op and its kernel entry point match the reference's
oracle, op and Pallas kernel in interpret mode within the reference test's
atol 1e-4 / rtol 1e-5.  On CPU tensors nothing is launched.
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
                                               slab_contrib_sums_ref)

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


def _unpacked(keys) -> int:
    """Rows with a non-EMPTY lane after an EMPTY lane."""
    return int((keys != _packed(keys)).any(axis=1).sum())


def _t(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _check_all_forms(keys, owner, contrib, V, R):
    """The plain version, the op and the entry point against the
    reference's oracle, op and Pallas kernel, with no launch counted."""
    valid = (keys < V) & (owner[:, None] >= 0)
    want = np.asarray(jref(jnp.asarray(keys), jnp.asarray(owner),
                           jnp.asarray(contrib), n_vertices=V))
    pallas = np.asarray(slab_contrib_sums_pallas(
        jnp.asarray(keys), jnp.asarray(owner), jnp.asarray(contrib),
        n_vertices=V, rows_per_block=R, interpret=True))
    want_op = np.asarray(jop(jnp.asarray(keys), jnp.asarray(valid),
                             jnp.asarray(contrib)))
    before = dict(runtime.LAUNCHES)
    plain = slab_contrib_sums_ref(_t(keys), torch.from_numpy(owner),
                                  torch.from_numpy(contrib), n_vertices=V)
    entry = slab_contrib_sums_cuda(_t(keys), torch.from_numpy(owner),
                                   torch.from_numpy(contrib), n_vertices=V)
    op = slab_contrib_sums(_t(keys), torch.from_numpy(valid),
                           torch.from_numpy(contrib))
    assert runtime.LAUNCHES == before
    for got in (plain, entry, op):
        assert got.dtype == torch.float32 and got.shape == keys.shape[:1]
    for got in (plain, entry):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    np.testing.assert_allclose(op.numpy(), want_op, **TOL)


@pytest.mark.parametrize("S,V,R", CASES)
def test_ref_matches_reference_on_unpacked_rows(S, V, R):
    keys, owner, contrib = _rows(S, V)
    assert _unpacked(keys) > 0
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
def test_op_matches_reference_on_unpacked_rows(S, V, R):
    keys, owner, contrib = _rows(S, V)
    assert _unpacked(keys) > 0
    _check_all_forms(keys, owner, contrib, V, R)


@pytest.mark.parametrize("S,V,R", CASES)
def test_op_matches_reference_on_packed_rows(S, V, R):
    keys, owner, contrib = _rows(S, V)
    keys = _packed(keys)
    assert _unpacked(keys) == 0
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


def _row(kind, V):
    """One hand-built row of 128 lanes and its owner."""
    row = np.full(128, EMPTY, np.uint32)
    if kind == "tombstone_after_empty":
        row[[0, 7, 9, 127]] = [3, TOMB, 4, 5]
    elif kind == "key_at_or_above_v":
        row[:6] = [1, V, V + 7, 2, 0x7FFFFFFF, 0xFFFFFFFF]
    elif kind == "full":
        row[:] = np.arange(128) % V
    elif kind == "unowned_with_keys":
        row[:40] = np.arange(40) % V
        return row, -1
    # "empty_allocated": every lane EMPTY, owner >= 0
    return row, 6


@pytest.mark.parametrize("kind", ["tombstone_after_empty", "key_at_or_above_v",
                                  "empty_allocated", "full",
                                  "unowned_with_keys"])
def test_hand_built_row_matches_reference(kind):
    V = 50
    rng = np.random.default_rng(7)
    contrib = rng.standard_normal(V).astype(np.float32)
    keys, owner = _rows(3, V)[:2]        # neighbours of the row under test
    row, own = _row(kind, V)
    keys[1], owner[1] = row, own
    _check_all_forms(keys, owner, contrib, V, 8)
    got = slab_contrib_sums_cuda(_t(keys), torch.from_numpy(owner),
                                 torch.from_numpy(contrib), n_vertices=V)
    lanes = row[(row < V)] if own >= 0 else row[:0]
    np.testing.assert_allclose(float(got[1]),
                               float(contrib[lanes.astype(np.int64)].sum()),
                               **TOL)
