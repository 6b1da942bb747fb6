"""AdamW with global-norm clipping and linear warmup, from
``repro.train.optimizer``.

Functional, as the reference's: ``init`` builds (m, v, count) with the
parameters' tree structure (nested dicts and tuples, leaves in JAX's
flatten order: dict keys sorted), float32 moments and a 0-d int32
``count``, so ``checkpoint.ckpt`` writes the same leaves as the
reference's and either package restores the other's ``(params,
opt_state)``.  ``update`` is the reference's arithmetic in its order:
the clip scale ``min(1, clip / max(gnorm, 1e-9))``, the learning rate
warmed up on ``count``, bias corrections on ``count + 1``, float32
moments, the parameters cast back to their dtype.

Departure: ``update(..., inplace=True)`` writes the new parameters and
moments into the tensors passed in (the reference's jitted step may donate
its buffers; PyTorch has no donation, and at 16 bytes a parameter the
old and new trees together would not fit a card).  The default returns
new tensors and leaves its arguments alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    device = tree_leaves(params)[0].device
    return AdamWState(m=zeros, v=tree_map(torch.clone, zeros),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=device))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 squares, a 0-d
    float32 tensor."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
           inplace: bool = False) -> Tuple[Any, AdamWState]:
    """One AdamW step: (new params, new state).  With ``inplace`` the new
    parameters and moments are written into ``params``, ``state.m`` and
    ``state.v`` (and returned), one leaf at a time."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.count + 1
    lr = _schedule(cfg, state.count)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        del g
        step_val = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p2 = (p.float() - lr * step_val).to(p.dtype)
        if not inplace:
            return p2, m2, v2
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
        return p, m, v

    flat_p = tree_leaves(params)
    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        flat_p)]
    return (tree_unflatten(params, [o[0] for o in out]),
            AdamWState(m=tree_unflatten(params, [o[1] for o in out]),
                       v=tree_unflatten(params, [o[2] for o in out]),
                       count=step))
