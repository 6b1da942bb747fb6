"""NequIP (arXiv:2101.03164), from ``repro.models.gnn.nequip``:
E(3)-equivariant interatomic potential.

Assigned config: 5 layers, 32 channels, l_max=2, 8 Bessel RBFs, cutoff 5 A.
Each interaction block: tensor-product convolution (``equivariant_conv``),
per-l self-interaction linear, residual, equivariant gate.  Readout: an MLP
on the scalar channel gives per-atom site energies, summed per graph.
``init_params`` takes a ``torch.Generator``: the reference's distributions,
not its numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .common import (GraphBatch, apply_mlp, init_mlp, params_from_numpy,
                     segment_sum)
from .tensor_field import (apply_linear_per_l, equivariant_conv, gate,
                           init_conv, linear_per_l)

__all__ = ["NequIPConfig", "init_params", "forward", "energy_loss",
           "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 10


def init_params(cfg: NequIPConfig, generator: torch.Generator) -> Dict:
    dev = generator.device
    l_set = list(range(cfg.l_max + 1))
    params: Dict = {
        "embed": torch.randn((cfg.n_species, cfg.channels),
                             generator=generator, device=dev) * 0.5,
        "readout": init_mlp(generator, (cfg.channels, 32, 1)),
    }
    for i in range(cfg.n_layers):
        params[f"conv{i}"] = init_conv(generator, l_max=cfg.l_max,
                                       channels=cfg.channels,
                                       n_rbf=cfg.n_rbf)
        params[f"self{i}"] = linear_per_l(generator, l_set, cfg.channels,
                                          cfg.channels)
        params[f"gate{i}"] = (torch.randn(
            (cfg.channels, cfg.channels), generator=generator, device=dev)
            * cfg.channels ** -0.5)
    return params


def forward(params: Dict, batch: GraphBatch,
            cfg: NequIPConfig) -> torch.Tensor:
    """Per-graph potential energies: (n_graphs,)."""
    h = {0: params["embed"][batch.species.long()][:, :, None]}  # (N, C, 1)

    for i in range(cfg.n_layers):
        m = equivariant_conv(params[f"conv{i}"], h, batch, l_max=cfg.l_max,
                             channels=cfg.channels, n_rbf=cfg.n_rbf,
                             cutoff=cfg.cutoff)
        m = apply_linear_per_l(params[f"self{i}"], m)
        # residual on overlapping l's
        h = {l: (m[l] + h[l] if l in h else m[l]) for l in m}
        h = gate(h, params[f"gate{i}"])

    site = apply_mlp(params["readout"], h[0][..., 0])[:, 0]  # (N,)
    site = site * batch.node_mask
    return segment_sum(site, batch.graph_ids, batch.n_graphs)


def energy_loss(params, batch, targets, cfg):
    e = forward(params, batch, cfg)
    return torch.mean((e - targets) ** 2)
