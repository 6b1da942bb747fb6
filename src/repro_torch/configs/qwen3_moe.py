"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B], from
``repro.configs.qwen3_moe``.

48L d_model=2048 32H (GQA kv=4, head_dim=128, QK-norm) moe_d_ff=768
vocab=151936, MoE 128 experts top-8, untied head.
"""
import torch

from ..models.transformer import LMConfig
from .common import LM_SHAPES

ARCH_ID = "qwen3-moe-30b-a3b"
FAMILY = "lm"
SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": "pure full-attention arch; no sub-quadratic path"}


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936, n_experts=128, top_k=8,
        qk_norm=True, tie_embeddings=False, rope_theta=1000000.0,
        dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128, n_experts=8,
        top_k=2, capacity_factor=8.0, qk_norm=True, tie_embeddings=False,
        dtype=torch.float32)
