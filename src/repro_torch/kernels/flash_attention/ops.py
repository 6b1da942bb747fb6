"""The public flash-attention op, from
``repro.kernels.flash_attention.ops.flash_attention``.

``impl="auto"`` launches the hand-written kernels for CUDA tensors and runs
the plain ``attention_ref`` for CPU tensors (``core.device.resolve_impl``).
On CUDA tensors of which one requires a gradient (with grad mode on), the
op is ``FlashAttention``, an autograd function whose forward launches the
forward kernel with its row log-sum-exp and whose backward launches the
backward kernel; otherwise it is the plain forward launch.  There is no
path from CUDA tensors to the plain version: a kernel that does not build
or launch raises.  On CPU tensors ``attention_ref``'s own autograd gives
the gradient, as ``jax.grad`` of the reference's ``attention_ref`` does
(the reference's Pallas kernel has no VJP).  The layout is the
reference's: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D).  The reference's
``block_q``/``block_k`` tiling options have no counterpart: the kernels'
tiles are fixed.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.device import resolve_impl
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """Kernel 10 with its hand-written backward: the forward saves (q, k,
    v, o, lse), the backward launches ``flash_attention_bwd_cuda``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, sm_scale, kv_len):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      softcap=softcap, sm_scale=sm_scale,
                                      kv_len=kv_len, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      sm_scale=sm_scale, kv_len=kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse,
                                              do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


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
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    kv_len = Skv if kv_len is None else kv_len
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                    float(softcap), float(sm_scale),
                                    int(kv_len))
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, sm_scale=sm_scale,
                                kv_len=kv_len)
