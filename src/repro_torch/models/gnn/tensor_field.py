"""Shared tensor-product machinery for NequIP and MACE, from
``repro.models.gnn.tensor_field``.

Irrep features are dicts {l: (N, C, 2l+1)}.  The equivariant convolution
(message) is

    m_i^{l_out} = sum_{j in N(i)} sum_{paths (l_in, l_f) -> l_out}
                  w_path,c(r_ij) CG^{l_out}_{l_in l_f} (h_j^{l_in} (x) Y^{l_f}(r^_ij))

with per-path per-channel radial weights from an MLP over a Bessel basis
(NequIP's interaction block).  MACE layers reuse the same A-basis, then add
the higher-correlation product basis (``tensor_power``).

The reference's three-operand einsums are contracted small operands first,
so that no (E, C, 2l1+1, 2l2+1) tensor is held: the convolution contracts
Y with the CG block, then gathers h through a batched product; the tensor
power is ``CGProduct``, whose backward recomputes what it needs from its
two inputs.  Dicts are walked, and partial sums taken, in the reference's
order.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .common import (apply_mlp, bessel_rbf, init_mlp, poly_cutoff,
                     segment_sum)
from .irreps import cg_tensor, clebsch_gordan_real, real_sph_harm


def allowed_paths(l_in_set: Sequence[int], l_f_max: int,
                  l_out_set: Sequence[int]) -> List[Tuple[int, int, int]]:
    paths = []
    for li in l_in_set:
        for lf in range(l_f_max + 1):
            for lo in l_out_set:
                if abs(li - lf) <= lo <= li + lf:
                    paths.append((li, lf, lo))
    return paths


def conv_paths(l_max: int) -> List[Tuple[int, int, int]]:
    """The static path list shared by ``init_conv`` and
    ``equivariant_conv`` (kept out of the parameter tree)."""
    return allowed_paths(range(l_max + 1), l_max, range(l_max + 1))


def init_conv(generator: torch.Generator, *, l_max: int, channels: int,
              n_rbf: int) -> Dict:
    paths = conv_paths(l_max)
    return {"radial": init_mlp(generator, (n_rbf, 64, len(paths) * channels))}


def equivariant_conv(params: Dict, h: Dict[int, torch.Tensor], batch, *,
                     l_max: int, channels: int, n_rbf: int,
                     cutoff: float) -> Dict[int, torch.Tensor]:
    """One tensor-product message-passing step; returns the aggregated
    messages."""
    snd, rcv, emask = (batch.senders.long(), batch.receivers.long(),
                       batch.edge_mask)
    n_nodes = batch.n_nodes
    vec = batch.positions[rcv] - batch.positions[snd]
    r = torch.linalg.norm(vec, dim=-1)
    Y = real_sph_harm(vec, l_max)
    rb = bessel_rbf(r, n_rbf, cutoff) * poly_cutoff(r, cutoff)[:, None]
    paths = conv_paths(l_max)
    w = apply_mlp(params["radial"], rb).reshape(r.shape[0], len(paths),
                                                channels)
    w = w * emask[:, None, None]

    gathered: Dict[int, torch.Tensor] = {}
    out: Dict[int, torch.Tensor] = {}
    for p_idx, (li, lf, lo) in enumerate(paths):
        if li not in h:
            continue
        if li not in gathered:
            gathered[li] = h[li][snd]                    # (E, C, 2li+1)
        C = cg_tensor(li, lf, lo, vec.device)
        # "eci,ej,ijk->eck": Y with the CG block, then with h
        T = torch.einsum("ej,ijk->eik", Y[lf], C)        # (E, 2li+1, 2lo+1)
        msg = torch.bmm(gathered[li], T)
        msg = msg * w[:, p_idx, :, None]
        agg = segment_sum(msg, rcv, n_nodes)
        out[lo] = out.get(lo, 0.0) + agg
    return out


def linear_per_l(generator: torch.Generator, l_set, c_in: int,
                 c_out: int) -> Dict:
    dev = generator.device
    return {f"l{l}": (torch.randn((c_in, c_out), generator=generator,
                                  device=dev) * c_in ** -0.5)
            for l in l_set}


def apply_linear_per_l(p: Dict, h: Dict[int, torch.Tensor]
                       ) -> Dict[int, torch.Tensor]:
    return {l: torch.einsum("nci,cd->ndi", v, p[f"l{l}"])
            for l, v in h.items()}


def gate(h: Dict[int, torch.Tensor],
         gate_w: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Equivariant gating: scalars SiLU'd; l > 0 scaled by
    sigmoid(W . scalars)."""
    out = {0: F.silu(h[0])}
    if len(h) > 1:
        g = torch.sigmoid(h[0][..., 0] @ gate_w)          # (N, C)
        for l, v in h.items():
            if l > 0:
                out[l] = v * g[..., None]
    return out


class CGProduct(torch.autograd.Function):
    """t[n, c, k] = sum_ij a[n, c, i] b[n, c, j] C[i, j, k] (the reference's
    "nci,ncj,ijk->nck") with only ``a`` and ``b`` saved: the (N, C, i, j)
    products live one block at a time, forward and backward."""

    @staticmethod
    def forward(ctx, a, b, C):
        i, j, k = C.shape
        ctx.save_for_backward(a, b, C)
        u = (a.reshape(-1, i) @ C.reshape(i, j * k)).view(-1, j, k)
        t = (u * b.reshape(-1, j, 1)).sum(dim=1)
        return t.view(a.shape[0], a.shape[1], k)

    @staticmethod
    def backward(ctx, g):
        a, b, C = ctx.saved_tensors
        i, j, k = C.shape
        g = g.reshape(-1, 1, k)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            gu = (g * b.reshape(-1, j, 1)).reshape(-1, j * k)
            ga = (gu @ C.reshape(i, j * k).T).view(a.shape)
        if ctx.needs_input_grad[1]:
            u = (a.reshape(-1, i) @ C.reshape(i, j * k)).view(-1, j, k)
            gb = (u * g).sum(dim=2).view(b.shape)
        return ga, gb, None


def tensor_power(h: Dict[int, torch.Tensor], A: Dict[int, torch.Tensor],
                 weights: Dict, l_out_set) -> Dict[int, torch.Tensor]:
    """One correlation-order increase of MACE's product basis:
    B^l = sum_{l1, l2} w_{l1 l2 l} CG(h^{l1} (x) A^{l2}), channel-wise."""
    out: Dict[int, torch.Tensor] = {}
    for l1, v1 in h.items():
        for l2, v2 in A.items():
            for lo in l_out_set:
                if not (abs(l1 - l2) <= lo <= l1 + l2):
                    continue
                key = f"p{l1}_{l2}_{lo}"
                if key not in weights:
                    continue
                C = cg_tensor(l1, l2, lo, v1.device)
                t = CGProduct.apply(v1, v2, C)
                out[lo] = out.get(lo, 0.0) + t * weights[key][None, :, None]
    return out


def init_tensor_power(generator: torch.Generator, l_in_set, l_a_set,
                      l_out_set, channels: int) -> Dict:
    dev = generator.device
    ws = {}
    for l1 in l_in_set:
        for l2 in l_a_set:
            for lo in l_out_set:
                if abs(l1 - l2) <= lo <= l1 + l2:
                    ws[f"p{l1}_{l2}_{lo}"] = torch.randn(
                        (channels,), generator=generator, device=dev) * 0.1
    return ws
