"""Dense attention: the plain version of the flash-attention kernel, from
``repro.kernels.flash_attention.ref.attention_ref``.

Masks use absolute indices from 0 for both queries and keys (query i sees
key j when ``i >= j`` under ``causal`` and ``i - j < window`` under a
window), not right-aligned ones.  A row with no visible key gives 0.  The
(B, H, Sq, Skv) float32 score tensor is updated in place, so it is the only
full-size intermediate.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  sm_scale: Optional[float] = None,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Dense attention with GQA / causal / sliding-window / softcap /
    kv_len: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) -> q's shape and
    dtype, computed in float32."""
    _, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    if kv_len is None:
        kv_len = Skv

    kk = k.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk)
    del kk
    s.mul_(sm_scale)
    if softcap > 0.0:
        s.div_(softcap).tanh_().mul_(softcap)

    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = (kj < kv_len).expand(Sq, Skv)
    if causal:
        mask = mask & (qi >= kj)
    if window > 0:
        mask = mask & ((qi - kj) < window)
    hidden = ~mask
    s.masked_fill_(hidden, float("-inf"))
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.masked_fill_(hidden, 0.0)      # rows with no visible key: nan -> 0
    denom = s.sum(dim=-1, keepdim=True)
    s.div_(torch.where(denom > 0, denom, torch.ones_like(denom)))
    vv = v.float().repeat_interleave(group, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", s, vv).to(q.dtype)
