"""Port parity: EmbeddingBag against the JAX reference on the CPU.

The port's op (its plain version on CPU tensors) against the reference's
Pallas kernel in interpret mode, on the reference test's four cases and on
batches with all-pad bags, and at the widths and bag lengths that take
the card kernel's other paths, at the reference test's tolerances: 1e-5 in
float32 (another summation order) and 3e-2 with a bfloat16 table (one
rounding of the output).  The op returns the table's dtype, as the
reference's kernel does; the plain version promotes as the reference's
oracle does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synth import recsys_batches as jrecsys_batches
from repro.kernels.embedding_bag.kernel import embedding_bag_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jbag_ref
from repro_torch.data.synth import recsys_batches
from repro_torch.kernels.embedding_bag import embedding_bag, \
    embedding_bag_ref

CASES = [
    (8, 4, 100, 32, "float32", 0.0),
    (64, 16, 1000, 64, "float32", 0.0),
    (100, 8, 500, 128, "float32", 0.0),
    (32, 8, 256, 64, "bfloat16", 0.0),
    (64, 16, 1000, 64, "float32", 0.25),    # a quarter of the bags all pad
    (32, 8, 256, 64, "bfloat16", 0.25),
    # the card kernel's paths: widths it loads 16 bytes a lane (8, 64,
    # 128, 256), one lane (1) or element by element (33, 100), and bag
    # lengths of one slot, one and two 32-slot ballots and four 64-slot
    # stages
    (16, 1, 100, 1, "float32", 0.0),
    (16, 33, 300, 8, "bfloat16", 0.0),
    (8, 200, 500, 33, "float32", 0.25),
    (16, 50, 1000, 100, "bfloat16", 0.0),
    (8, 32, 200, 256, "float32", 0.0),
    (8, 50, 300, 256, "bfloat16", 0.25),
    (4, 200, 400, 128, "bfloat16", 0.0),
]


@pytest.mark.parametrize("B,L,N,D,dtype,empty", CASES)
def test_embedding_bag_matches_reference(B, L, N, D, dtype, empty):
    rng = np.random.default_rng(7)
    idx = rng.integers(0, N, (B, L)).astype(np.int32)
    idx[rng.random((B, L)) < 0.2] = -1  # ragged bags
    idx[rng.random(B) < empty] = -1     # bags with no slot at all
    w = rng.standard_normal((B, L)).astype(np.float32)
    table = rng.standard_normal((N, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = embedding_bag_pallas(jnp.asarray(idx), jnp.asarray(w),
                                jnp.asarray(table, jdt), bags_per_block=32,
                                interpret=True)
    t_idx, t_w = torch.from_numpy(idx), torch.from_numpy(w)
    t_table = torch.from_numpy(table).to(tdt)
    got = embedding_bag(t_idx, t_w, t_table)
    assert got.dtype == tdt and got.shape == (B, D)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    plain = embedding_bag_ref(t_idx, t_w, t_table)
    oracle = jbag_ref(jnp.asarray(idx), jnp.asarray(w),
                      jnp.asarray(table, jdt))
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=1e-5)
    pad_bags = (idx < 0).all(axis=1)
    assert not got[torch.from_numpy(pad_bags)].any()


def test_recsys_batches_match_reference():
    """One seed gives the same histories, masks and targets in both
    packages (the bags of ``chip_smoke.py``'s EmbeddingBag phase)."""
    for got, want in zip(zip(range(2), recsys_batches(2 ** 21, 64, 50,
                                                      seed=0)),
                         jrecsys_batches(2 ** 21, 64, 50, seed=0)):
        for a, b in zip(got[1], want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
