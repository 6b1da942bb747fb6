"""Real spherical harmonics, SO(3) rotations and Clebsch–Gordan tables, from
``repro.models.gnn.irreps``.

* ``real_sph_harm``: orthonormal real SH Y_l^m up to l_max (associated
  Legendre and cos/sin(m phi) recursions), vectorised over points.
* ``wigner_d_real``: rotation matrices D^l(R) acting on real SH vectors
  by the Ivanic–Ruedenberg (1996) recursion, vectorised over batched R.
* ``clebsch_gordan_real``: real-basis CG coefficients C^{l3}_{l1 l2}
  (numpy, computed once per (l1, l2, l3) and cached: the port keeps its
  own copy of the reference's tables); ``cg_tensor`` is the same block as
  a tensor, made once per (l1, l2, l3, device, dtype).
* ``align_to_z``: the rotation taking a unit edge vector onto +z (the
  eSCN/EquiformerV2 frame change).

The algebra is held by Y(Rv) = D(R) Y(v), D(R1 R2) = D(R1) D(R2), D
orthogonal, and C (D a (x) D b) = D (C (a (x) b)).  The recursion compounds
float32 rounding with l: at l = 6 the reference's own tests hold it to
1e-4.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# real spherical harmonics
# ---------------------------------------------------------------------------


def real_sph_harm(vec: torch.Tensor, l_max: int,
                  normalized: bool = True) -> List[torch.Tensor]:
    """vec (..., 3), need not be unit (normalised here).

    Returns [Y_0 (..., 1), Y_1 (..., 3), ..., Y_l (..., 2l+1)], m-ordered
    -l..l, orthonormal on the sphere.
    """
    eps = 1e-12
    r = torch.linalg.norm(vec, dim=-1, keepdim=True)
    v = vec / torch.clamp(r, min=eps)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    rho = torch.sqrt(torch.clamp(x * x + y * y, min=eps * eps))
    cphi = torch.where(rho > eps, x / rho, 1.0)
    sphi = torch.where(rho > eps, y / rho, 0.0)

    # associated Legendre P_l^m(z), m >= 0, with st = sqrt(1 - z^2)
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    P: Dict[Tuple[int, int], torch.Tensor] = {}
    P[(0, 0)] = torch.ones_like(z)
    for m in range(1, l_max + 1):
        # P_m^m = (2m-1)!! st^m (Condon–Shortley phase dropped, as in
        # wigner_d_real's convention)
        P[(m, m)] = P[(m - 1, m - 1)] * (2 * m - 1) * st
    for m in range(0, l_max):
        P[(m + 1, m)] = z * (2 * m + 1) * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    # cos(m phi), sin(m phi) recursions
    cos_m = [torch.ones_like(z), cphi]
    sin_m = [torch.zeros_like(z), sphi]
    for m in range(2, l_max + 1):
        c_prev, s_prev = cos_m[m - 1], sin_m[m - 1]
        cos_m.append(cphi * c_prev - sphi * s_prev)
        sin_m.append(sphi * c_prev + cphi * s_prev)

    out = []
    for l in range(l_max + 1):
        comps = []
        for m in range(-l, l + 1):
            am = abs(m)
            if normalized:
                nrm = math.sqrt((2 * l + 1) / (4 * math.pi)
                                * math.factorial(l - am)
                                / math.factorial(l + am))
            else:
                nrm = 1.0
            if m > 0:
                comps.append(math.sqrt(2.0) * nrm * P[(l, am)] * cos_m[am])
            elif m == 0:
                comps.append(nrm * P[(l, 0)])
            else:
                comps.append(math.sqrt(2.0) * nrm * P[(l, am)] * sin_m[am])
        out.append(torch.stack(comps, dim=-1))
    return out


# ---------------------------------------------------------------------------
# Wigner D for real SH: Ivanic & Ruedenberg recursion
# ---------------------------------------------------------------------------

def _ivanic_uvw(l: int, m: int, n: int) -> Tuple[float, float, float]:
    d = 1.0 if m == 0 else 0.0
    denom = float((l + n) * (l - n)) if abs(n) < l \
        else float((2 * l) * (2 * l - 1))
    u = math.sqrt((l + m) * (l - m) / denom)
    v = 0.5 * math.sqrt((1 + d) * (l + abs(m) - 1) * (l + abs(m)) / denom) \
        * (1 - 2 * d)
    w = -0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * (1 - d)
    return u, v, w


def wigner_d_real(R: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """R (..., 3, 3) rotation matrices -> [D^0, D^1, ..., D^l] with D^l
    (..., 2l+1, 2l+1) acting on real-SH component vectors (m = -l..l):
    Y_l(R v) = D^l(R) Y_l(v)."""
    batch = tuple(R.shape[:-2])
    one = torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)
    Ds = [one]
    if l_max == 0:
        return Ds

    # D^1 in real-SH order (m = -1, 0, 1) = (y, z, x)
    perm = [1, 2, 0]
    D1 = torch.stack(
        [torch.stack([R[..., perm[i], perm[j]] for j in range(3)], dim=-1)
         for i in range(3)], dim=-2)
    Ds.append(D1)

    def r1(i, j):  # i, j in {-1, 0, 1}
        return D1[..., i + 1, j + 1]

    for l in range(2, l_max + 1):
        prev = Ds[l - 1]

        def rlm1(a, b):  # a, b in [-(l-1), l-1]
            return prev[..., a + l - 1, b + l - 1]

        def P(i, a, b):
            if b == l:
                return r1(i, 1) * rlm1(a, l - 1) - r1(i, -1) * rlm1(a, -(l - 1))
            if b == -l:
                return r1(i, 1) * rlm1(a, -(l - 1)) + r1(i, -1) * rlm1(a, l - 1)
            return r1(i, 0) * rlm1(a, b)

        rows = []
        for m in range(-l, l + 1):
            cols = []
            for n in range(-l, l + 1):
                u, v, w = _ivanic_uvw(l, m, n)
                term = 0.0
                if u != 0.0:
                    term = term + u * P(0, m, n)
                if v != 0.0:
                    if m == 0:
                        vv = P(1, 1, n) + P(-1, -1, n)
                    elif m > 0:
                        vv = P(1, m - 1, n) * math.sqrt(1 + (m == 1)) \
                            - P(-1, -m + 1, n) * (0.0 if m == 1 else 1.0)
                    else:
                        vv = P(1, m + 1, n) * (0.0 if m == -1 else 1.0) \
                            + P(-1, -m - 1, n) * math.sqrt(1 + (m == -1))
                    term = term + v * vv
                if w != 0.0:
                    if m > 0:
                        ww = P(1, m + 1, n) + P(-1, -m - 1, n)
                    else:  # w == 0 when m == 0
                        ww = P(1, m - 1, n) - P(-1, -m + 1, n)
                    term = term + w * ww
                cols.append(term)
            rows.append(torch.stack(cols, dim=-1))
        Ds.append(torch.stack(rows, dim=-2))
    return Ds


def align_to_z(vec: torch.Tensor) -> torch.Tensor:
    """Rotation R (..., 3, 3) with R v^ = z^ (the eSCN/EquiformerV2 edge
    frame): about n^ = v^ x z^ by the angle between v^ and z^; the
    identity, or the flip diag(1, -1, -1) for v^ = -z^, where v^ x z^
    vanishes."""
    eps = 1e-7
    v = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True),
                          min=eps)
    c = v[..., 2]                                       # cos = v . z
    axis = torch.stack([v[..., 1], -v[..., 0], torch.zeros_like(c)], dim=-1)
    s = torch.linalg.norm(axis, dim=-1)                 # sin = |v x z|
    n = axis / torch.clamp(s, min=eps)[..., None]
    ax, ay, az = n[..., 0], n[..., 1], n[..., 2]
    zeros = torch.zeros_like(ax)
    K = torch.stack([
        torch.stack([zeros, -az, ay], dim=-1),
        torch.stack([az, zeros, -ax], dim=-1),
        torch.stack([-ay, ax, zeros], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device).expand(K.shape)
    rodrigues = eye + s[..., None, None] * K \
        + (1 - c)[..., None, None] * (K @ K)
    flip_x = torch.tensor(np.diag([1.0, -1.0, -1.0]), dtype=vec.dtype,
                          device=vec.device).expand(K.shape)
    degen = torch.where(c[..., None, None] > 0, eye, flip_x)
    return torch.where((s > eps)[..., None, None], rodrigues, degen)


# ---------------------------------------------------------------------------
# Clebsch–Gordan (real basis), numpy, cached
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """<l1 m1 l2 m2 | l3 m3> (Racah formula), shape (2l1+1, 2l2+1, 2l3+1)."""
    f = math.factorial
    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if l3 < abs(l1 - l2) or l3 > l1 + l2:
        return C
    pref_l = math.sqrt(
        (2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3)
        / f(l1 + l2 + l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pref_m = math.sqrt(
                f(l3 + m3) * f(l3 - m3)
                * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2))
            s = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                d1 = l1 + l2 - l3 - k
                d2 = l1 - m1 - k
                d3 = l2 + m2 - k
                d4 = l3 - l2 + m1 + k
                d5 = l3 - l1 - m2 + k
                if min(d1, d2, d3, d4, d5) < 0:
                    continue
                s += (-1) ** k / (f(k) * f(d1) * f(d2) * f(d3) * f(d4) * f(d5))
            C[m1 + l1, m2 + l2, m3 + l3] = pref_l * pref_m * s
    return C


@lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """U with Y_complex = U @ Y_real (rows m_c, cols m_r), complex, with
    the Condon–Shortley phase folded in to match ``real_sph_harm``."""
    U = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    s2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        if m > 0:
            # complex m > 0 from real (cos part = col m, sin part = col -m)
            U[m + l, m + l] = (-1) ** m * s2
            U[m + l, -m + l] = (-1) ** m * 1j * s2
        elif m == 0:
            U[l, l] = 1.0
        else:
            U[m + l, -m + l] = s2
            U[m + l, m + l] = -1j * s2
    return U


@lru_cache(maxsize=None)
def clebsch_gordan_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C (2l1+1, 2l2+1, 2l3+1):
    (a (x) b)_{l3, m3} = sum C[m1, m2, m3] a_{m1} b_{m2} is equivariant."""
    Cc = _cg_complex(l1, l2, l3)
    U1, U2, U3 = (_real_to_complex(l) for l in (l1, l2, l3))
    # C_real[i,j,k] = sum conj(U1[a,i]) conj(U2[b,j]) Cc[a,b,c] U3[c,k]
    Cr = np.einsum("ai,bj,abc,ck->ijk", np.conj(U1), np.conj(U2), Cc, U3)
    # the result is real or purely imaginary per (l1, l2, l3) parity; take
    # the dominating part and verify the other vanishes
    re, im = np.real(Cr), np.imag(Cr)
    if np.abs(im).max() > np.abs(re).max():
        out = im
    else:
        out = re
    resid = min(np.abs(re).max(), np.abs(im).max())
    assert resid < 1e-10, (l1, l2, l3, resid)
    return np.ascontiguousarray(out)


def cg_tensor(l1: int, l2: int, l3: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``clebsch_gordan_real(l1, l2, l3)`` as a tensor on ``device``, made
    once per (l1, l2, l3, device, dtype).  Under a ``FakeTensorMode`` (the
    dry run's trace) the tensor is fake, so it is made anew and not cached:
    a cached fake tensor would stand in for the real one afterwards."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is not None:
        return _cg_tensor.__wrapped__(l1, l2, l3, device, dtype)
    return _cg_tensor(l1, l2, l3, device, dtype)


@lru_cache(maxsize=None)
def _cg_tensor(l1: int, l2: int, l3: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(clebsch_gordan_real(l1, l2, l3), dtype=dtype,
                        device=device)
