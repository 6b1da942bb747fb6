"""Port parity: ``models/gnn/irreps.py`` against ``repro.models.gnn.irreps``
on the CPU, case by case after ``tests/test_irreps.py``.

Each case holds the port's function to the reference's on the same inputs
(float32) and repeats the reference test's property on the port.  The
tolerance against the reference is 1e-5 absolute at every l.  Measured on
the CPU over 8 seeds of 16 rotations and 256 vectors: ``wigner_d_real``
bit-equal to l = 6 (the Ivanic recursion is the same float32 products in
the same order in both packages; it compounds rounding with l, which is
why the reference's own property tests allow 1e-4), ``real_sph_harm``
within 3.6e-7 (l = 6) and ``align_to_z`` within 2.4e-7.  The properties
keep the reference test's tolerances (1e-4 for the Wigner algebra to
l = 6, 1e-5 for the CG blocks and frames).  The CG tables are the port's
own copy of the reference's numpy and must be equal bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import irreps as jirr
from repro_torch.models.gnn import irreps as tirr

L_MAX = 6
ATOL = 1e-5


def rand_rot(rng):
    """Random rotation via QR of a Gaussian matrix (det forced +1)."""
    M = rng.standard_normal((3, 3))
    Q, _ = np.linalg.qr(M)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("l_max", range(L_MAX + 1))
def test_sph_harm_matches_reference(l_max):
    rng = np.random.default_rng(l_max)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    # the poles (rho = 0) and an unnormalised vector
    v[:3] = [[0, 0, 2.0], [0, 0, -1.0], [3.0, 4.0, 0.0]]
    got = tirr.real_sph_harm(_t(v), l_max)
    want = jirr.real_sph_harm(jnp.asarray(v), l_max)
    assert len(got) == len(want) == l_max + 1
    for l, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == (64, 2 * l + 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=f"l={l}")


def test_sph_harm_l1_is_yzx():
    v = np.asarray([[0.3, -0.5, 0.81]], np.float32)
    Y = tirr.real_sph_harm(_t(v), 1)
    n = v[0] / np.linalg.norm(v[0])
    c = math.sqrt(3 / (4 * math.pi))
    np.testing.assert_allclose(Y[1][0].numpy(),
                               c * np.array([n[1], n[2], n[0]]), atol=1e-6)


def test_sph_harm_orthonormal():
    """Monte-Carlo: the integral of Y_i Y_j over the sphere is delta_ij
    over the whole l <= 3 block."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((200000, 3))
    Y = tirr.real_sph_harm(_t(v), 3)
    flat = np.concatenate([y.numpy() for y in Y], axis=1)
    gram = flat.T @ flat / len(v) * 4 * math.pi
    np.testing.assert_allclose(gram, np.eye(16), atol=0.05)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wigner_equivariance(seed):
    """Y_l(R v) == D_l(R) Y_l(v), and D_l(R) equal to the reference's."""
    rng = np.random.default_rng(seed)
    R = rand_rot(rng)
    v = rng.standard_normal((32, 3))
    Y_v = tirr.real_sph_harm(_t(v), L_MAX)
    Y_Rv = tirr.real_sph_harm(_t(v @ R.T), L_MAX)
    Ds = tirr.wigner_d_real(_t(R), L_MAX)
    jDs = jirr.wigner_d_real(jnp.asarray(R, jnp.float32), L_MAX)
    for l in range(L_MAX + 1):
        np.testing.assert_allclose(Ds[l].numpy(), np.asarray(jDs[l]),
                                   atol=ATOL, err_msg=f"l={l}")
        got = Y_v[l].numpy() @ Ds[l].numpy().T
        np.testing.assert_allclose(got, Y_Rv[l].numpy(), atol=1e-4,
                                   err_msg=f"l={l}")


def test_wigner_composition_and_orthogonality():
    rng = np.random.default_rng(3)
    R1, R2 = rand_rot(rng), rand_rot(rng)
    D1 = tirr.wigner_d_real(_t(R1), L_MAX)
    D2 = tirr.wigner_d_real(_t(R2), L_MAX)
    D12 = tirr.wigner_d_real(_t(R1 @ R2), L_MAX)
    jD12 = jirr.wigner_d_real(jnp.asarray(R1 @ R2, jnp.float32), L_MAX)
    for l in range(L_MAX + 1):
        np.testing.assert_allclose(D12[l].numpy(), np.asarray(jD12[l]),
                                   atol=ATOL, err_msg=f"l={l}")
        a = D1[l].numpy() @ D2[l].numpy()
        np.testing.assert_allclose(a, D12[l].numpy(), atol=1e-4)
        eye = D1[l].numpy() @ D1[l].numpy().T
        np.testing.assert_allclose(eye, np.eye(2 * l + 1), atol=1e-4)


def test_wigner_batched():
    rng = np.random.default_rng(4)
    Rs = np.stack([rand_rot(rng) for _ in range(8)])
    Ds = tirr.wigner_d_real(_t(Rs), 2)
    jDs = jirr.wigner_d_real(jnp.asarray(Rs, jnp.float32), 2)
    for i in range(8):
        Di = tirr.wigner_d_real(_t(Rs[i]), 2)
        for l in range(3):
            assert tuple(Ds[l].shape) == (8, 2 * l + 1, 2 * l + 1)
            np.testing.assert_allclose(Ds[l][i].numpy(), Di[l].numpy(),
                                       atol=1e-6)
            np.testing.assert_allclose(Ds[l][i].numpy(),
                                       np.asarray(jDs[l][i]), atol=ATOL)


def test_cg_tensor_keeps_fake_tensors_out_of_its_cache():
    """A block made under the dry run's ``FakeTensorMode`` is fake; the
    next call outside the trace still gets the real table."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    dev = torch.device("cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = tirr.cg_tensor(3, 2, 4, dev, torch.float64)
    assert isinstance(fake, FakeTensor)
    real = tirr.cg_tensor(3, 2, 4, dev, torch.float64)
    assert not isinstance(real, FakeTensor)
    assert real is tirr.cg_tensor(3, 2, 4, dev, torch.float64)
    np.testing.assert_array_equal(real.numpy(),
                                  tirr.clebsch_gordan_real(3, 2, 4))


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 0), (1, 1, 1), (1, 1, 2),
                                      (2, 1, 1), (2, 2, 2), (2, 2, 0),
                                      (2, 1, 2), (2, 2, 1)])
def test_cg_equivariance(l1, l2, l3):
    """C (D a (x) D b) == D (C (a (x) b)), and the table equal to the
    reference's bit for bit, its tensor once per device and dtype."""
    rng = np.random.default_rng(5)
    C = tirr.clebsch_gordan_real(l1, l2, l3)
    assert np.array_equal(C, jirr.clebsch_gordan_real(l1, l2, l3))
    assert np.abs(C).max() > 1e-6, "CG identically zero"
    Ct = tirr.cg_tensor(l1, l2, l3, torch.device("cpu"))
    assert Ct is tirr.cg_tensor(l1, l2, l3, torch.device("cpu"))
    assert Ct.dtype == torch.float32
    np.testing.assert_array_equal(Ct.numpy(), C.astype(np.float32))
    R = rand_rot(rng)
    Ds = [d.double().numpy() for d in
          tirr.wigner_d_real(torch.from_numpy(R), max(l1, l2, l3))]
    a = rng.standard_normal(2 * l1 + 1)
    b = rng.standard_normal(2 * l2 + 1)
    lhs = np.einsum("ijk,i,j->k", C, Ds[l1] @ a, Ds[l2] @ b)
    rhs = Ds[l3] @ np.einsum("ijk,i,j->k", C, a, b)
    np.testing.assert_allclose(lhs, rhs, atol=1e-5)


def test_align_to_z():
    """R v^ = z^ with det R = 1, including v^ = +z^ and the degenerate
    c <= 0 branch (v^ = -z^: the flip), and R equal to the reference's."""
    rng = np.random.default_rng(6)
    v = rng.standard_normal((64, 3))
    v = np.concatenate([v, [[0, 0, 1.0]], [[0, 0, -1.0]],
                        [[0, 0, -3.0]]], axis=0)
    R = tirr.align_to_z(_t(v)).numpy()
    want = np.asarray(jirr.align_to_z(jnp.asarray(v, jnp.float32)))
    np.testing.assert_allclose(R, want, atol=ATOL)
    np.testing.assert_array_equal(R[-2], np.diag([1.0, -1.0, -1.0]))
    np.testing.assert_array_equal(R[-3], np.eye(3))
    n = v / np.linalg.norm(v, axis=-1, keepdims=True)
    out = np.einsum("nij,nj->ni", R, n)
    np.testing.assert_allclose(out, np.tile([0, 0, 1.0], (len(v), 1)),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), np.ones(len(v)), atol=1e-5)
