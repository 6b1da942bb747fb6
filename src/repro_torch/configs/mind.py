"""mind [arXiv:1904.08030], from ``repro.configs.mind``: multi-interest
retrieval with capsule routing.

embed_dim=64 n_interests=4 capsule_iters=3.  The user -> item interaction
stream is a dynamic bipartite graph: behaviour histories are read from a
live SlabGraph's slab lists (``models.recsys.mind.history_from_slab``).
"""
from ..models.recsys.mind import MINDConfig
from .common import RECSYS_SHAPES

ARCH_ID = "mind"
FAMILY = "recsys"
SHAPES = dict(RECSYS_SHAPES)
SKIP = {}


def full_config() -> MINDConfig:
    return MINDConfig(n_items=2 ** 21, embed_dim=64, n_interests=4,
                      capsule_iters=3, hist_len=50)


def smoke_config() -> MINDConfig:
    return MINDConfig(n_items=512, embed_dim=16, n_interests=4,
                      capsule_iters=3, hist_len=12)
