"""Dense attention: the plain versions of the flash-attention kernels, from
``repro.kernels.flash_attention.ref.attention_ref``.

Masks use absolute indices from 0 for both queries and keys (query i sees
key j when ``i >= j`` under ``causal`` and ``i - j < window`` under a
window), not right-aligned ones.  A row with no visible key gives 0.
Without autograd the (B, H, Sq, Skv) float32 score tensor is updated in
place, so it is the only full-size intermediate; when an input requires a
gradient, ``attention_ref`` runs the reference's out-of-place formulas, so
that its autograd is the reference's ``jax.grad``.

``attention_lse_ref`` is the forward kernel's row log-sum-exp and
``attention_bwd_ref`` the backward kernel's (dq, dk, dv), in plain float32:
the versions the card holds those kernels to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def visibility(Sq: int, Skv: int, *, causal: bool, window: int,
               kv_len: Optional[int] = None, device=None) -> torch.Tensor:
    """The (Sq, Skv) bool mask of the (query, key) pairs attention sees:
    query i sees key j when j < kv_len, i >= j (causal) and i - j < window
    (window > 0), absolute indices from 0."""
    if kv_len is None:
        kv_len = Skv
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Skv, device=device)[None, :]
    mask = (kj < kv_len).expand(Sq, Skv)
    if causal:
        mask = mask & (qi >= kj)
    if window > 0:
        mask = mask & ((qi - kj) < window)
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int,
            sm_scale: Optional[float], kv_len: Optional[int]):
    """(scaled scores (B, Hq, Sq, Skv) float32, visibility mask (Sq, Skv),
    sm_scale): q (B, Hq, Sq, D) against k (B, Hkv, Skv, D) repeated over
    each group of Hq / Hkv query heads."""
    _, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    kk = k.float().repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk)
    mask = visibility(Sq, Skv, causal=causal, window=window, kv_len=kv_len,
                      device=q.device)
    return s, mask, sm_scale


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  sm_scale: Optional[float] = None,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Dense attention with GQA / causal / sliding-window / softcap /
    kv_len: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) -> q's shape and
    dtype, computed in float32."""
    group = q.shape[1] // k.shape[1]
    s, mask, sm_scale = _scores(q, k, causal=causal, window=window,
                                sm_scale=sm_scale, kv_len=kv_len)
    hidden = ~mask
    vv = v.float().repeat_interleave(group, dim=1)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # the reference's formulas, out of place, for autograd
        s = s * sm_scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(hidden, float("-inf"))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p.masked_fill(hidden, 0.0)
        denom = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
        return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    s.mul_(sm_scale)
    if softcap > 0.0:
        s.div_(softcap).tanh_().mul_(softcap)
    s.masked_fill_(hidden, float("-inf"))
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.masked_fill_(hidden, 0.0)      # rows with no visible key: nan -> 0
    denom = s.sum(dim=-1, keepdim=True)
    s.div_(torch.where(denom > 0, denom, torch.ones_like(denom)))
    return torch.einsum("bhqk,bhkd->bhqd", s, vv).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, sm_scale: Optional[float] = None,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """Each row's log-sum-exp over its scaled, softcapped, visible scores
    (B, Hq, Sq) float32, the forward kernel's ``lse``: +inf for a row with
    no visible key, so that exp(x - lse) is 0 for every key."""
    with torch.no_grad():
        s, mask, sm_scale = _scores(q, k, causal=causal, window=window,
                                    sm_scale=sm_scale, kv_len=kv_len)
        s.mul_(sm_scale)
        if softcap > 0.0:
            s.div_(softcap).tanh_().mul_(softcap)
        s.masked_fill_(~mask, float("-inf"))
        lse = torch.logsumexp(s, dim=-1)
        return lse.masked_fill_(~mask.any(dim=-1), float("inf"))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, sm_scale: Optional[float] = None,
                      kv_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's formulas in plain float32: from the forward's
    inputs, output ``o``, row log-sum-exp ``lse`` and the output's gradient
    ``do`` -> (dq, dk, dv) in the inputs' dtype.  ``delta = sum(do * o)``,
    ``P = exp(x - lse)`` (0 where masked), ``dS = P (dO V^T - delta)``, times
    the softcap's ``1 - tanh^2`` and ``sm_scale``; dq = dS K, dk = dS^T Q and
    dv = P^T dO, summed over each KV head's group of query heads."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    with torch.no_grad():
        s, mask, sm_scale = _scores(q, k, causal=causal, window=window,
                                    sm_scale=sm_scale, kv_len=kv_len)
        s.mul_(sm_scale)
        dcap = None
        if softcap > 0.0:
            t = s.div_(softcap).tanh_()
            dcap = 1.0 - t * t
            s = t.mul_(softcap)
        p = s.sub_(lse[..., None].float()).exp_().masked_fill_(~mask, 0.0)
        del s
        dof = do.float()
        vv = v.float().repeat_interleave(group, dim=1)
        ds = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
        del vv
        delta = (dof * o.float()).sum(dim=-1)
        ds.sub_(delta[..., None]).mul_(p)
        if dcap is not None:
            ds.mul_(dcap)
            del dcap
        ds.mul_(sm_scale)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        del p
        kk = k.float().repeat_interleave(group, dim=1)
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk)
        del kk
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
        fold = (B, Hkv, group, Skv, D)
        return (dq.to(q.dtype), dk.view(fold).sum(dim=2).to(k.dtype),
                dv.view(fold).sum(dim=2).to(v.dtype))
