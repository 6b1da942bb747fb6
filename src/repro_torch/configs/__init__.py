"""Registry of the ported architectures: ``get_arch("<id>")`` -> config
module (ARCH_ID, FAMILY, SHAPES, SKIP, full_config(), smoke_config()).

The five LMs of ``repro.configs`` (two MoE, three dense), the four GNNs
and MIND, in the reference's order.  The graph plane's config
(``meerkat_graph``), ``ASSIGNED`` and ``all_cells`` belong to the dry run
(ROADMAP §1).
"""
from . import (equiformer_v2, gemma2_9b, gemma_2b, mace, mind, nequip,
               phi35_moe, pna, qwen15_32b, qwen3_moe)

_MODULES = [phi35_moe, qwen3_moe, gemma_2b, gemma2_9b, qwen15_32b,
            mace, nequip, pna, equiformer_v2, mind]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}


def get_arch(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown or unported arch '{arch_id}'; ported: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]
