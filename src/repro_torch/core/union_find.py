"""Union-find for (incremental) weakly connected components.

The paper hooks roots with lock-free CAS and compresses paths fully.  Here,
as in the reference, a batch union hooks the larger root of every edge whose
endpoints lie in different trees under the smaller one with one scatter-min
(conflicting hooks on a root keep the smallest), then compresses by pointer
doubling, until no edge joins two trees.  Every root ends as the minimum
vertex id of its component, so the result does not depend on the order in
which hooks land, and it is bit-identical to the reference.

Each loop of the reference (``jax.lax.while_loop``) is a host loop here that
reads its condition once per round.
"""
from __future__ import annotations

import torch

_INT32_MAX = 2 ** 31 - 1


def init_parents(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def compress(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: ``parent <- parent[parent]`` to a fixpoint."""
    while True:
        pp = parent[parent.long()]
        if not bool((pp != parent).any()):
            return parent
        parent = pp


def find(parent: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Roots of a batch of vertices; ``parent`` must be compressed."""
    return parent[v.long()]


def union_batch(parent: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Union the edges ``(u, v)`` where ``mask`` is set: hook the larger
    root under the smaller until no masked edge joins two trees."""
    n = parent.shape[0]
    parent = compress(parent)
    ui = torch.where(mask, u, 0).long()
    vi = torch.where(mask, v, 0).long()
    active = mask & (parent[ui] != parent[vi])
    while bool(active.any()):
        ru, rv = parent[ui], parent[vi]
        # lanes that join nothing hook into a spare last slot, then dropped
        tgt = torch.where(active, torch.maximum(ru, rv), n).long()
        buf = torch.cat([parent, parent.new_full((1,), _INT32_MAX)])
        buf.scatter_reduce_(0, tgt, torch.minimum(ru, rv), "amin",
                            include_self=True)
        parent = compress(buf[:n])
        active = mask & (parent[ui] != parent[vi])
    return parent


def component_labels(parent: torch.Tensor) -> torch.Tensor:
    """Representative (minimum-id root) of every vertex."""
    return compress(parent)


def count_components(parent: torch.Tensor) -> int:
    p = compress(parent)
    return int((p == torch.arange(p.shape[0], device=p.device)).sum())
