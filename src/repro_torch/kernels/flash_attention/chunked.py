"""Flash-schedule attention in plain PyTorch, from
``repro.kernels.flash_attention.chunked.attention_chunked``: the online
softmax over KV blocks of ``block_k`` keys, as the reference's XLA
schedule (a ``lax.scan`` there, a Python loop here).  It is no Pallas
kernel, so its port is plain: it runs on any device, and autograd
differentiates it as ``jax.grad`` does the reference's.  Peak attention
memory is O(Sq · block_k) a head, not O(Sq · Skv).  The reference's
``unroll`` (a dry-run calibration switch) comes with the dry run (ROADMAP
item 5.5).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, sm_scale: Optional[float] = None,
                      kv_len: Optional[int] = None,
                      block_k: int = 512) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D); GQA via Hq % Hkv == 0 ->
    q's shape and dtype, computed in float32.  ``block_k`` must divide Skv
    once cut to it (``min(block_k, Skv)``), as the reference asserts."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    if kv_len is None:
        kv_len = Skv
    bk = min(block_k, Skv)
    if Skv % bk:
        raise ValueError(f"block_k {bk} does not divide Skv {Skv}")

    qg = q.reshape(B, Hkv, group, Sq, D).float()
    qi = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hkv, group, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, group, Sq), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((B, Hkv, group, Sq, D), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Skv, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb) * sm_scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        kj = k0 + torch.arange(bk, device=q.device)[None, :]
        mask = kj < kv_len
        if causal:
            mask = mask & (qi >= kj)
        if window > 0:
            mask = mask & ((qi - kj) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vb)
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)
