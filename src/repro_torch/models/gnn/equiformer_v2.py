"""EquiformerV2 (arXiv:2306.12059), from ``repro.models.gnn.equiformer_v2``:
equivariant graph attention via eSCN.

Assigned config: 12 layers, 128 channels, l_max=6, m_max=2, 8 heads.

The eSCN trick: instead of O(L^6) CG tensor products, rotate each edge's
features into a frame where the edge is +z; there the tensor product with
Y(z^) is block-diagonal in m, so an SO(2) linear layer over |m| <= m_max
mixes all l-channels at O(L^3).  Feature layout: {l: (N, C, 2l+1)}.

Per layer: equivariant RMS norm, eSCN graph attention (logits from the
invariant m = 0 block, values the SO(2)-conv'd messages rotated back),
residual, gated equivariant FFN, residual.

Departures from the reference:

* ``init_params`` takes a ``torch.Generator``: the reference's
  distributions, and its sharing (``w_m{m}_i`` is half of ``w_m{m}_r``, and
  every ``ffn_lin`` block one draw, as its keys give them), not its numbers.
* The reference's writes ``out.at[...].set`` become ``torch.stack`` of the
  written components beside zeros, out of place.
* Float32 only, one pass over every edge with the full-m rotation: the
  reference's ``compute_dtype``, ``edge_chunks`` and ``trunc_rotation``
  levers (set only by its dry run) and its sharding constraints
  (``constrain``, the identity on one device) are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from .common import (GraphBatch, apply_mlp, init_mlp, params_from_numpy,
                     segment_softmax, segment_sum)
from .irreps import align_to_z, wigner_d_real

__all__ = ["EquiformerV2Config", "init_params", "forward", "energy_loss",
           "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_species: int = 10
    cutoff: float = 5.0


def _ls(cfg):
    return list(range(cfg.l_max + 1))


def init_params(cfg: EquiformerV2Config, generator: torch.Generator) -> Dict:
    dev = generator.device
    C = cfg.channels

    def lin(shape, scale=None):
        s = scale if scale is not None else shape[0] ** -0.5
        return torch.randn(shape, generator=generator, device=dev) * s

    params: Dict = {
        "embed": torch.randn((cfg.n_species, C), generator=generator,
                             device=dev) * 0.5,
        "readout": init_mlp(generator, (C, C, 1)),
    }
    for i in range(cfg.n_layers):
        lay: Dict = {}
        # SO(2) conv weights: m = 0 real mix; m > 0 complex-pair mix, per m
        n_l0 = cfg.l_max + 1
        lay["w_m0"] = lin((n_l0 * C, n_l0 * C))
        for m in range(1, cfg.m_max + 1):
            n_lm = cfg.l_max + 1 - m   # number of l's with l >= m
            lay[f"w_m{m}_r"] = lin((n_lm * C, n_lm * C))
            lay[f"w_m{m}_i"] = lay[f"w_m{m}_r"] * 0.5
        lay["attn"] = init_mlp(generator, (C, C, cfg.n_heads))
        lay["ffn_scalar"] = init_mlp(generator, (C, 2 * C, C))
        lay["ffn_gate"] = lin((C, C * cfg.l_max))
        w = lin((C, C))
        lay["ffn_lin"] = {f"l{l}": w.clone() for l in _ls(cfg)}
        params[f"layer{i}"] = lay
    return params


def _eq_norm(h: Dict[int, torch.Tensor], eps=1e-6) -> Dict[int, torch.Tensor]:
    """Equivariant RMS norm: each l-block scaled by its RMS over (C, m)."""
    out = {}
    for l, v in h.items():
        rms = torch.sqrt(torch.mean(torch.square(v), dim=(1, 2), keepdim=True)
                         + eps)
        out[l] = v / rms
    return out


def _rotate(h: Dict[int, torch.Tensor], Ds: List[torch.Tensor],
            transpose=False) -> Dict[int, torch.Tensor]:
    """"eij,ecj->eci" (or "eji,ecj->eci") per l as batched products."""
    return {l: torch.bmm(v, Ds[l] if transpose else Ds[l].transpose(1, 2))
            for l, v in h.items()}


def _placed(like: torch.Tensor, cols: Dict[int, torch.Tensor]) -> torch.Tensor:
    """A tensor shaped as ``like`` (E, C, n), zero but for the component
    columns ``cols`` {index: (E, C)}."""
    zero = like.new_zeros(like.shape[:2])
    return torch.stack([cols.get(i, zero) for i in range(like.shape[2])],
                       dim=-1)


def _so2_conv(hr: Dict[int, torch.Tensor], lay: Dict,
              cfg: EquiformerV2Config) -> Dict[int, torch.Tensor]:
    """SO(2) linear layer in the edge frame; truncates |m| > m_max (eSCN).
    Component m of block l sits at l + m."""
    E = hr[0].shape[0]
    C = cfg.channels
    cols = {l: {} for l in _ls(cfg)}
    x0 = torch.stack([hr[l][:, :, l] for l in _ls(cfg)], dim=-1)
    y0 = (x0.reshape(E, -1) @ lay["w_m0"]).reshape(E, C, cfg.l_max + 1)
    for li, l in enumerate(_ls(cfg)):
        cols[l][l] = y0[:, :, li]
    for m in range(1, cfg.m_max + 1):
        ls_m = [l for l in _ls(cfg) if l >= m]
        # real SH ordering: component m is at l + m; -m at l - m
        xc = torch.stack([hr[l][:, :, l + m] for l in ls_m], -1)
        xs = torch.stack([hr[l][:, :, l - m] for l in ls_m], -1)
        xcf = xc.reshape(E, -1)
        xsf = xs.reshape(E, -1)
        wr = lay[f"w_m{m}_r"]
        wi = lay[f"w_m{m}_i"]
        yc = (xcf @ wr - xsf @ wi).reshape(E, C, len(ls_m))
        ys = (xcf @ wi + xsf @ wr).reshape(E, C, len(ls_m))
        for li, l in enumerate(ls_m):
            cols[l][l + m] = yc[:, :, li]
            cols[l][l - m] = ys[:, :, li]
    return {l: _placed(hr[l], cols[l]) for l in _ls(cfg)}


def _edge_attention(lay, hn, batch, Ds, cfg, snd, rcv, emask):
    """eSCN attention layer: returns per-node aggregates."""
    N = batch.n_nodes
    he = {l: hn[l][snd] for l in _ls(cfg)}
    conv = _so2_conv(_rotate(he, Ds), lay, cfg)
    inv = conv[0][:, :, 0]                                # (E, C)
    logits = apply_mlp(lay["attn"], F.silu(inv))          # (E, heads)
    alpha = torch.stack(
        [segment_softmax(logits[:, hd], rcv, N, emask)
         for hd in range(cfg.n_heads)], dim=-1)            # (E, heads)
    Ch = cfg.channels // cfg.n_heads
    w_edge = torch.repeat_interleave(alpha, Ch, dim=1)    # (E, C)
    vals = _rotate(conv, Ds, transpose=True)              # back to global
    msg = {l: vals[l] * w_edge[:, :, None] * emask[:, None, None]
           for l in _ls(cfg)}
    return {l: segment_sum(msg[l], rcv, N) for l in _ls(cfg)}


def forward(params: Dict, batch: GraphBatch,
            cfg: EquiformerV2Config) -> torch.Tensor:
    """Per-graph energies (n_graphs,)."""
    C = cfg.channels
    N = batch.n_nodes
    snd, rcv, emask = (batch.senders.long(), batch.receivers.long(),
                       batch.edge_mask)
    vec = batch.positions[rcv] - batch.positions[snd]
    Ds = wigner_d_real(align_to_z(vec), cfg.l_max)

    emb = params["embed"][batch.species.long()][:, :, None]
    h: Dict[int, torch.Tensor] = {
        l: (emb * torch.ones((1, 1, 2 * l + 1), device=emb.device)
            if l == 0 else
            torch.zeros((N, C, 2 * l + 1), device=emb.device))
        for l in _ls(cfg)}

    for i in range(cfg.n_layers):
        lay = params[f"layer{i}"]
        hn = _eq_norm(h)
        agg = _edge_attention(lay, hn, batch, Ds, cfg, snd, rcv, emask)
        h = {l: h[l] + agg[l] for l in _ls(cfg)}

        # gated FFN
        hn = _eq_norm(h)
        s = apply_mlp(lay["ffn_scalar"], hn[0][:, :, 0])
        gates = torch.sigmoid(hn[0][:, :, 0] @ lay["ffn_gate"])
        gates = gates.reshape(N, C, cfg.l_max)
        upd = {0: h[0] + s[:, :, None]}
        for l in range(1, cfg.l_max + 1):
            v = torch.einsum("nci,cd->ndi", hn[l], lay["ffn_lin"][f"l{l}"])
            upd[l] = h[l] + v * gates[:, :, l - 1][:, :, None]
        h = upd

    site = apply_mlp(params["readout"], h[0][:, :, 0])[:, 0]
    site = site * batch.node_mask
    return segment_sum(site, batch.graph_ids, batch.n_graphs)


def energy_loss(params, batch, targets, cfg):
    e = forward(params, batch, cfg)
    return torch.mean((e - targets) ** 2)
