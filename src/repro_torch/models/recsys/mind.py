"""MIND, Multi-Interest Network with Dynamic routing (arXiv:1904.08030),
from ``repro.models.recsys.mind``.

Embedding dim 64, 4 interest capsules, 3 routing iterations: a history's
item embeddings (gathered rows of a 2**21-row table) are routed into
interest capsules (B2I dynamic routing), candidates are scored by the max
over the interests, and training's label-aware attention and sampled
softmax over in-batch negatives give ``train_loss``.  Histories can be
read straight out of a live ``SlabGraph`` (user vertex -> item slab
lists): ``history_from_slab``.

Departures from the reference:

* ``init_params`` takes a ``torch.Generator``: the same distributions, not
  the same numbers.
* The sharding constraint (``constrain``, the table's ``embed_rows``) sits
  at the reference's two sites: the identity outside a rules context or on
  a plain tensor.
* ``serve_scores`` and ``retrieval_scores`` take the max over the interests
  one interest at a time, so a (B, K, Nc) score tensor is never held; the
  scores are the same products.
* ``history_from_slab`` walks every user's chain at once, one hop a step
  (the reference ``vmap``s a per-user ``slab_iterator``), and stops a
  user's walk once its history is full.
* ``train_loss`` takes the gold logit as each user's dot product with its
  own target, not the diagonal of the (B, B) in-batch logits (the same
  value up to summation order), and the logits' log-sum-exp through
  ``InBatchLogSumExp``, which keeps the (B, B) logits only inside its
  forward and its backward (it recomputes them there): at ``train_batch``
  autograd's ``logsumexp`` would hold three 17.2 GB tensors at once.  The
  table gather's backward accumulates the rows' gradients with
  ``index_put_``, which sorts the indices on CUDA and adds each row's
  contributions in order (deterministic).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ...core.device import resolve_device
from ...distributed.sharding import constrain
from ...core.hashing import INVALID_SLAB, is_valid_vertex


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 2 ** 21           # production-scale sparse table
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0               # label-aware attention sharpness
    neg_groups: int = 1              # shard-local in-batch negatives
    routing_dtype: str = "f32"       # or "bf16": the routing in bfloat16


def init_params(cfg: MINDConfig, generator: torch.Generator) -> Dict:
    """The item table (n_items, D), normal * 0.05, and the bilinear map S
    (D, D), normal * D ** -0.5, float32 on the generator's device."""
    dev = generator.device
    D = cfg.embed_dim
    return {
        "item_embed": torch.randn((cfg.n_items, D), generator=generator,
                                  device=dev).mul_(0.05),
        "S": torch.randn((D, D), generator=generator,
                         device=dev).mul_(D ** -0.5)}


def params_from_numpy(tree: Dict, device) -> Dict:
    """The reference's parameter dict, as numpy arrays, on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in tree.items()}


def squash(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = v.square().sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


def extract_interests(params: Dict, hist: torch.Tensor,
                      hist_mask: torch.Tensor, cfg: MINDConfig
                      ) -> torch.Tensor:
    """hist (B, L) int item ids (-1 padding) -> interest capsules (B, K, D)
    float32 through B2I routing."""
    B, L = hist.shape
    dev = hist.device
    table = constrain(params["item_embed"], "embed_rows")
    e = table[hist.clamp_min(0).long()]                      # (B, L, D)
    if cfg.routing_dtype == "bf16":
        e = e.to(torch.bfloat16)
        hist_mask = hist_mask.to(torch.bfloat16)
    e = e * hist_mask[..., None]
    el = e @ params["S"].to(e.dtype)                         # (B, L, D)
    del e
    # the fixed routing-logit init: a deterministic function of the
    # interest and the history position
    k = torch.arange(cfg.n_interests, dtype=torch.float32, device=dev)
    pos = torch.arange(L, dtype=torch.float32, device=dev)
    b = torch.sin(k[None, :, None] * (1.0 + pos[None, None, :]))
    b = b.expand(B, cfg.n_interests, L)
    u = None
    for _ in range(cfg.capsule_iters):
        c = torch.softmax(b, dim=1).to(el.dtype)             # over interests
        c = c * hist_mask[:, None, :]
        u = squash(torch.einsum("bkl,bld->bkd", c, el).float())
        b = b + torch.einsum("bkd,bld->bkl", u.to(el.dtype), el).float()
    return u


def label_aware_attention(interests: torch.Tensor, target_e: torch.Tensor,
                          p: float) -> torch.Tensor:
    """(B, K, D) interests against (B, D) targets -> user vectors (B, D)."""
    scores = torch.einsum("bkd,bd->bk", interests, target_e)
    w = torch.softmax((scores.abs() + 1e-9) ** p * torch.sign(scores),
                      dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


class InBatchLogSumExp(torch.autograd.Function):
    """``logsumexp_c(u[g, b] . t[g, c])`` (G, b) of users ``u`` and targets
    ``t`` (G, b, D): the in-batch logits are made, reduced in place as
    ``torch.logsumexp`` reduces them (max, exp of the difference, sum, log,
    the max added back) and dropped; the backward makes them again and
    turns them in place into their gradient, ``exp(logits - lse) * grad``.
    One (G, b, b) float32 tensor lives at a time."""

    @staticmethod
    def forward(ctx, u, t):
        logits = torch.einsum("gbd,gcd->gbc", u, t)
        m = logits.amax(dim=-1, keepdim=True)
        lse = logits.sub_(m).exp_().sum(dim=-1).log_()
        lse.add_(m.squeeze(-1).masked_fill_(m.squeeze(-1).isinf(), 0))
        ctx.save_for_backward(u, t, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        u, t, lse = ctx.saved_tensors
        g = torch.einsum("gbd,gcd->gbc", u, t)
        g.sub_(lse[..., None]).exp_().mul_(grad[..., None])
        return (torch.einsum("gbc,gcd->gbd", g, t),
                torch.einsum("gbc,gbd->gcd", g, u))


def train_loss(params: Dict, hist: torch.Tensor, hist_mask: torch.Tensor,
               target: torch.Tensor, cfg: MINDConfig) -> torch.Tensor:
    """Sampled softmax with in-batch negatives (per group of B / G users
    when ``cfg.neg_groups`` > 1), a 0-d float32 value."""
    interests = extract_interests(params, hist, hist_mask, cfg)
    te = constrain(params["item_embed"], "embed_rows")[target.long()]
    user = label_aware_attention(interests, te, cfg.pow_p)
    B, D = user.shape
    G = cfg.neg_groups
    ug = user.reshape(G, B // G, D)
    tg = te.reshape(G, B // G, D)
    logz = InBatchLogSumExp.apply(ug, tg)
    gold = (ug * tg).sum(dim=-1)
    return (logz - gold).mean()


def _max_over_interests(interests: torch.Tensor, cand: torch.Tensor
                        ) -> torch.Tensor:
    """max_k interests[:, k] . cand[n] -> (B, Nc), one interest at a
    time."""
    s = interests[:, 0] @ cand.T
    for k in range(1, interests.shape[1]):
        s = torch.maximum(s, interests[:, k] @ cand.T)
    return s


def serve_scores(params: Dict, hist: torch.Tensor, hist_mask: torch.Tensor,
                 candidates: torch.Tensor, cfg: MINDConfig) -> torch.Tensor:
    """Online inference: (B, L) histories x (Nc,) candidate ids -> (B, Nc)
    scores, the max over the interests (the paper's serving rule)."""
    interests = extract_interests(params, hist, hist_mask, cfg)
    return _max_over_interests(
        interests, params["item_embed"][candidates.long()])


def retrieval_scores(params: Dict, hist: torch.Tensor,
                     hist_mask: torch.Tensor, cand_embed: torch.Tensor,
                     cfg: MINDConfig) -> torch.Tensor:
    """Retrieval over pre-materialised candidate embeddings (Nc, D): one
    batched product an interest."""
    interests = extract_interests(params, hist, hist_mask, cfg)
    return _max_over_interests(interests, cand_embed)


def history_from_slab(g, users, *, hist_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Behaviour histories out of the live interaction graph ``g``: user
    vertex ``u``'s first slab list (``slab_iterator(g, u, max_neighbors=
    hist_len)``, first bucket only) holds its item ids.  Returns ``hist``
    (B, hist_len) int32, the first ``hist_len`` items in chain order and -1
    past them, and ``mask`` (B, hist_len) float32.

    Every user's chain is walked at once, one hop a step (one host read a
    hop, for the rows still walking); a user stops once it holds
    ``hist_len`` items, which the rows after cannot change."""
    dev = g.device
    users = torch.as_tensor(users, device=dev).long().reshape(-1)
    B = users.numel()
    hist = torch.full((B, hist_len), -1, dtype=torch.int32, device=dev)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    cur = torch.where(g.bucket_count[users] > 0,
                      g.bucket_offset[users].long(), INVALID_SLAB)
    rows = torch.arange(B, device=dev)
    while True:
        walking = torch.nonzero((cur != INVALID_SLAB) & (n < hist_len),
                                as_tuple=True)[0]
        if not walking.numel():
            break
        at = cur[walking]
        keys = g.keys[at]                                     # (m, 128)
        ok = is_valid_vertex(keys)
        m = ok.to(torch.int64)
        pos = n[walking, None] + torch.cumsum(m, dim=1) - m
        put = ok & (pos < hist_len)
        hist[rows[walking, None].expand_as(pos)[put], pos[put]] = keys[put]
        n[walking] += m.sum(dim=1)
        cur[walking] = g.next_slab[at].long()
    mask = torch.arange(hist_len, device=dev)[None, :] \
        < n.clamp(max=hist_len)[:, None]
    return hist, mask.to(torch.float32)
