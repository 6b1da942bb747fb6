"""nequip [arXiv:2101.03164], from ``repro.configs.nequip``:
O(3)-equivariant interatomic potentials.

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5.
Meerkat applicability: DIRECT (dynamic neighbor lists), DESIGN.md §4.
"""
from ..models.gnn.nequip import NequIPConfig
from .common import GNN_SHAPES

ARCH_ID = "nequip"
FAMILY = "gnn"
SHAPES = dict(GNN_SHAPES)
SKIP = {}


def full_config() -> NequIPConfig:
    return NequIPConfig(n_layers=5, channels=32, l_max=2, n_rbf=8,
                        cutoff=5.0, n_species=100)


def smoke_config() -> NequIPConfig:
    return NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4,
                        cutoff=5.0, n_species=10)
