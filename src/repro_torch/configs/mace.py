"""mace [arXiv:2206.07697], from ``repro.configs.mace``:
higher-order E(3)-equivariant message passing.

n_layers=2 d_hidden=128 l_max=2 correlation=3 n_rbf=8.
Meerkat applicability: DIRECT: edge set served from the dynamic SlabGraph
(MD neighbor-list rebuilds = incremental edge batches), DESIGN.md §4.
"""
from ..models.gnn.mace import MACEConfig
from .common import GNN_SHAPES

ARCH_ID = "mace"
FAMILY = "gnn"
SHAPES = dict(GNN_SHAPES)
SKIP = {}


def full_config() -> MACEConfig:
    return MACEConfig(n_layers=2, channels=128, l_max=2, correlation=3,
                      n_rbf=8, cutoff=5.0, n_species=100)


def smoke_config() -> MACEConfig:
    return MACEConfig(n_layers=2, channels=8, l_max=2, correlation=3,
                      n_rbf=4, cutoff=5.0, n_species=10)
