"""Registry of the architectures: ``get_arch("<id>")`` -> config module
(ARCH_ID, FAMILY, SHAPES, SKIP, full_config(), smoke_config()), from
``repro.configs``.

The five LMs (two MoE, three dense), the four GNNs, MIND and the graph
plane's own config (``meerkat_graph``), in the reference's order.
``ASSIGNED`` is every architecture but the graph plane's, and
``all_cells`` their (arch, shape) cells.
"""
from . import (equiformer_v2, gemma2_9b, gemma_2b, mace, meerkat_graph,
               mind, nequip, phi35_moe, pna, qwen15_32b, qwen3_moe)

_MODULES = [phi35_moe, qwen3_moe, gemma_2b, gemma2_9b, qwen15_32b,
            mace, nequip, pna, equiformer_v2, mind, meerkat_graph]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ASSIGNED = [m.ARCH_ID for m in _MODULES if m is not meerkat_graph]


def get_arch(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells(include_skipped: bool = False):
    """Every assigned (arch, shape) cell; skipped cells annotated."""
    cells = []
    for aid in ASSIGNED:
        m = REGISTRY[aid]
        for shape in m.SHAPES:
            skip = m.SKIP.get(shape)
            if skip and not include_skipped:
                continue
            cells.append((aid, shape, skip))
    return cells
