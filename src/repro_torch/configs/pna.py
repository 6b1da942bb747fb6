"""pna [arXiv:2004.05718], from ``repro.configs.pna``:
principal neighbourhood aggregation.

n_layers=4 d_hidden=75, aggregators mean/max/min/std, scalers id/amp/atten.
Meerkat applicability: DIRECT (streaming edge inserts re-aggregate),
DESIGN.md §4.
"""
from ..models.gnn.pna import PNAConfig
from .common import GNN_SHAPES

ARCH_ID = "pna"
FAMILY = "gnn"
SHAPES = dict(GNN_SHAPES)
SKIP = {}


def full_config(d_in: int = 100, n_classes: int = 47) -> PNAConfig:
    return PNAConfig(n_layers=4, d_hidden=75, d_in=d_in,
                     n_classes=n_classes)


def smoke_config() -> PNAConfig:
    return PNAConfig(n_layers=2, d_hidden=16, d_in=24, n_classes=5)
