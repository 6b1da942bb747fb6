"""equiformer-v2 [arXiv:2306.12059], from ``repro.configs.equiformer_v2``:
SO(2)/eSCN equivariant graph attention.

n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8.
Meerkat applicability: DIRECT (dynamic neighbor lists), DESIGN.md §4.
"""
from ..models.gnn.equiformer_v2 import EquiformerV2Config
from .common import GNN_SHAPES

ARCH_ID = "equiformer-v2"
FAMILY = "gnn"
SHAPES = dict(GNN_SHAPES)
SKIP = {}


def full_config() -> EquiformerV2Config:
    return EquiformerV2Config(n_layers=12, channels=128, l_max=6, m_max=2,
                              n_heads=8, n_species=100)


def smoke_config() -> EquiformerV2Config:
    return EquiformerV2Config(n_layers=2, channels=16, l_max=3, m_max=2,
                              n_heads=4, n_species=10)
