"""The public flash-attention op, from
``repro.kernels.flash_attention.ops.flash_attention``.

``impl="auto"`` launches the hand-written kernel for CUDA tensors and runs
the plain ``attention_ref`` for CPU tensors (``core.device.resolve_impl``).
The layout is the reference's: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D).
The reference's ``block_q``/``block_k`` tiling options have no counterpart:
the kernel's tiles are fixed.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.device import resolve_impl
from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Attention forward with GQA, causal masking, a sliding window
    (``window`` > 0: query i sees keys j with i - j < window), tanh softcap
    and a ``kv_len`` bound on the keys; -> q's shape and dtype."""
    if resolve_impl(impl, q) == "torch":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, sm_scale=sm_scale,
                             kv_len=kv_len)
    D, Skv = q.shape[-1], k.shape[2]
    return flash_attention_cuda(
        q, k, v, causal=causal, window=window, softcap=softcap,
        sm_scale=D ** -0.5 if sm_scale is None else sm_scale,
        kv_len=Skv if kv_len is None else kv_len)
