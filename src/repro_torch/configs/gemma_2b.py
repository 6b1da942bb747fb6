"""gemma-2b [arXiv:2403.08295], from ``repro.configs.gemma_2b``.

18L d_model=2048 8H MQA (kv=1) head_dim=256 d_ff=16384 vocab=256000, GeGLU,
embedding scaling, tied embeddings.
"""
import torch

from ..models.transformer import LMConfig
from .common import LM_SHAPES

ARCH_ID = "gemma-2b"
FAMILY = "lm"
SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": "pure full-attention arch; no sub-quadratic path"}


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=256000, activation="geglu",
        embed_scale=True, tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=128,
        activation="geglu", embed_scale=True, tie_embeddings=True,
        dtype=torch.float32)
