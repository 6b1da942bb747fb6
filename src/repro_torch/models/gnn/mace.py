"""MACE (arXiv:2206.07697), from ``repro.models.gnn.mace``: higher-order
equivariant message passing.

Assigned config: 2 layers, 128 channels, l_max=2, correlation order 3,
8 RBFs.  Per layer: the A-basis is the tensor-product convolution (as
NequIP's); the B-basis the symmetric tensor powers of A up to nu = 3 (ACE
product basis) by chained CG contractions (``tensor_power``); the message
a per-l linear mix of the B_nu; the update linear plus a species-dependent
residual, with a scalar readout per layer.  ``init_params`` takes a
``torch.Generator``: the reference's distributions, not its numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .common import (GraphBatch, apply_mlp, init_mlp, params_from_numpy,
                     segment_sum)
from .tensor_field import (apply_linear_per_l, equivariant_conv, init_conv,
                           init_tensor_power, linear_per_l, tensor_power)

__all__ = ["MACEConfig", "init_params", "forward", "energy_loss",
           "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    channels: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 10


def init_params(cfg: MACEConfig, generator: torch.Generator) -> Dict:
    dev = generator.device
    l_set = list(range(cfg.l_max + 1))
    params: Dict = {
        "embed": torch.randn((cfg.n_species, cfg.channels),
                             generator=generator, device=dev) * 0.5,
    }
    for i in range(cfg.n_layers):
        params[f"conv{i}"] = init_conv(generator, l_max=cfg.l_max,
                                       channels=cfg.channels,
                                       n_rbf=cfg.n_rbf)
        for nu in range(2, cfg.correlation + 1):
            params[f"tp{i}_{nu}"] = init_tensor_power(
                generator, l_set, l_set, l_set, cfg.channels)
        for nu in range(1, cfg.correlation + 1):
            params[f"mix{i}_{nu}"] = linear_per_l(
                generator, l_set, cfg.channels, cfg.channels)
        params[f"res{i}"] = torch.randn(
            (cfg.n_species, cfg.channels), generator=generator,
            device=dev) * 0.1
        params[f"readout{i}"] = init_mlp(generator, (cfg.channels, 16, 1))
    return params


def forward(params: Dict, batch: GraphBatch, cfg: MACEConfig) -> torch.Tensor:
    """Per-graph energies (n_graphs,): the sum of per-layer site
    readouts."""
    species = batch.species.long()
    h = {0: params["embed"][species][:, :, None]}
    energy = torch.zeros((batch.n_graphs,), dtype=torch.float32,
                         device=species.device)

    for i in range(cfg.n_layers):
        A = equivariant_conv(params[f"conv{i}"], h, batch, l_max=cfg.l_max,
                             channels=cfg.channels, n_rbf=cfg.n_rbf,
                             cutoff=cfg.cutoff)
        # product basis: B_1 = A, B_nu = CG(B_{nu-1} (x) A)
        Bs = [A]
        for nu in range(2, cfg.correlation + 1):
            Bs.append(tensor_power(Bs[-1], A, params[f"tp{i}_{nu}"],
                                   range(cfg.l_max + 1)))
        msg: Dict[int, torch.Tensor] = {}
        for nu, B in enumerate(Bs, start=1):
            mixed = apply_linear_per_l(params[f"mix{i}_{nu}"], B)
            for l, v in mixed.items():
                msg[l] = msg.get(l, 0.0) + v
        res = params[f"res{i}"][species][:, :, None]
        h = {l: (v + (h[l] if l in h else 0.0)) for l, v in msg.items()}
        h[0] = h[0] + res

        site = apply_mlp(params[f"readout{i}"], h[0][..., 0])[:, 0]
        site = site * batch.node_mask
        energy = energy + segment_sum(site, batch.graph_ids, batch.n_graphs)
    return energy


def energy_loss(params, batch, targets, cfg):
    e = forward(params, batch, cfg)
    return torch.mean((e - targets) ** 2)
