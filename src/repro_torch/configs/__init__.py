"""Registry of the ported architectures: ``get_arch("<id>")`` -> config
module (ARCH_ID, FAMILY, SHAPES, SKIP, full_config(), smoke_config()).

The three dense LMs of ``repro.configs``; the MoE LMs wait for ``moe_ffn``
and the GNN and recsys configs for their models (ROADMAP §1).
"""
from . import gemma2_9b, gemma_2b, qwen15_32b

_MODULES = [gemma_2b, gemma2_9b, qwen15_32b]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}


def get_arch(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown or unported arch '{arch_id}'; ported: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]
