"""gemma2-9b [arXiv:2408.00118], from ``repro.configs.gemma2_9b``.

42L d_model=3584 16H (GQA kv=8) head_dim=256 d_ff=14336 vocab=256000;
local(4096)+global alternating layers, attn softcap 50, final softcap 30.
"""
import torch

from ..models.transformer import LMConfig
from .common import LM_SHAPES

ARCH_ID = "gemma2-9b"
FAMILY = "lm"
SHAPES = dict(LM_SHAPES)
SKIP = {}


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
        head_dim=256, d_ff=14336, vocab_size=256000, activation="geglu",
        sliding_window=4096, local_global_alternate=True,
        attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
        tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        activation="geglu", sliding_window=8, local_global_alternate=True,
        attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
        tie_embeddings=True, dtype=torch.float32)
