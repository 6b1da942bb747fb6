"""qwen1.5-32b [hf:Qwen/Qwen1.5-32B], from ``repro.configs.qwen15_32b``.

64L d_model=5120 40H (kv=40 — full MHA) head_dim=128 d_ff=27392
vocab=152064, QKV bias.
"""
import torch

from ..models.transformer import LMConfig
from .common import LM_SHAPES

ARCH_ID = "qwen1.5-32b"
FAMILY = "lm"
SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": "pure full-attention arch; no sub-quadratic path"}


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        head_dim=128, d_ff=27392, vocab_size=152064, qkv_bias=True,
        tie_embeddings=False, dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128, qkv_bias=True,
        tie_embeddings=False, dtype=torch.float32)
