"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct], from
``repro.configs.phi35_moe``.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2,
untied head.
"""
import torch

from ..models.transformer import LMConfig
from .common import LM_SHAPES

ARCH_ID = "phi3.5-moe-42b-a6.6b"
FAMILY = "lm"
SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": "pure full-attention arch; no sub-quadratic path"}


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=6400, vocab_size=32064, n_experts=16, top_k=2,
        tie_embeddings=False, rope_theta=10000.0, dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128, n_experts=4,
        top_k=2, capacity_factor=8.0, tie_embeddings=False,
        dtype=torch.float32)
