"""PNA, Principal Neighbourhood Aggregation (arXiv:2004.05718), from
``repro.models.gnn.pna``.

Assigned config: 4 layers, 75 hidden, aggregators {mean, max, min, std},
scalers {identity, amplification, attenuation}.  Message = MLP(h_i || h_j);
the 4 x 3 aggregator/scaler grid concatenates to 12 d, which an MLP
projects back: segment sums and maxima over the edge index (the SpMM
regime).  ``init_params`` takes a ``torch.Generator``: the reference's
distributions, not its numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .common import (GraphBatch, apply_mlp, degrees, init_mlp,
                     params_from_numpy, segment_max, segment_sum)

__all__ = ["PNAConfig", "init_params", "forward", "node_xent_loss",
           "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 64
    n_classes: int = 16
    delta: float = 2.5  # mean log-degree of the training graphs


def init_params(cfg: PNAConfig, generator: torch.Generator) -> Dict:
    params: Dict = {
        "encoder": init_mlp(generator, (cfg.d_in, cfg.d_hidden)),
        "decoder": init_mlp(generator, (cfg.d_hidden, cfg.d_hidden,
                                        cfg.n_classes)),
    }
    for i in range(cfg.n_layers):
        params[f"msg{i}"] = init_mlp(generator,
                                     (2 * cfg.d_hidden, cfg.d_hidden))
        params[f"upd{i}"] = init_mlp(generator,
                                     (13 * cfg.d_hidden, cfg.d_hidden))
    return params


def _aggregate(msg, rcv, emask, n_nodes, deg, delta):
    m = emask[:, None].to(msg.dtype)
    s = segment_sum(msg * m, rcv, n_nodes)
    d = torch.clamp(deg, min=1.0)[:, None]
    mean = s / d
    mx = segment_max(torch.where(emask[:, None], msg, -1e30), rcv, n_nodes)
    mx = torch.where(deg[:, None] > 0, mx, 0.0)
    mn = -segment_max(torch.where(emask[:, None], -msg, -1e30), rcv,
                      n_nodes)
    mn = torch.where(deg[:, None] > 0, mn, 0.0)
    sq = segment_sum(msg * msg * m, rcv, n_nodes) / d
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-8))

    aggs = [mean, mx, mn, std]
    logd = torch.log(deg + 1.0)[:, None]
    amp = logd / delta
    att = delta / torch.clamp(logd, min=1e-3)
    out = []
    for a in aggs:
        out += [a, a * amp, a * att]
    return torch.cat(out, dim=-1)                  # (N, 12 d)


def forward(params: Dict, batch: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    """Node logits (N, n_classes)."""
    h = apply_mlp(params["encoder"], batch.node_feat)
    deg = degrees(batch.receivers, batch.edge_mask, batch.n_nodes)
    snd, rcv = batch.senders.long(), batch.receivers.long()
    for i in range(cfg.n_layers):
        hj = h[snd]
        hi = h[rcv]
        msg = apply_mlp(params[f"msg{i}"], torch.cat([hi, hj], -1),
                        final_act=True)
        agg = _aggregate(msg, rcv, batch.edge_mask, batch.n_nodes, deg,
                         cfg.delta)
        h = h + apply_mlp(params[f"upd{i}"], torch.cat([h, agg], -1),
                          final_act=True)
    return apply_mlp(params["decoder"], h)


def node_xent_loss(params, batch, labels, cfg):
    logits = forward(params, batch, cfg).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
    per = (logz - gold) * batch.node_mask
    return per.sum() / torch.clamp(batch.node_mask.sum(), min=1)
