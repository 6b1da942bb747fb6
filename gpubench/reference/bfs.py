"""Plain reference BFS: levels from a source along out-edges, and the
check of a served tree (levels equal, each parent an in-neighbour one
level up).  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .edges import split


def bfs_levels(keys: torch.Tensor, n_vertices: int, source: int
               ) -> torch.Tensor:
    """Level of every vertex from ``source`` along out-edges, ``-1`` where
    unreached."""
    V = n_vertices
    src, dst = split(keys, V)
    dev = keys.device
    level = torch.full((V,), -1, dtype=torch.long, device=dev)
    level[source] = 0
    front = torch.zeros(V, dtype=torch.bool, device=dev)
    front[source] = True
    d = 0
    while bool(front.any()):
        reached = torch.zeros(V, dtype=torch.bool, device=dev)
        reached[dst[front[src]]] = True
        front = reached & (level < 0)
        d += 1
        level[front] = d
    return level


def bfs_errors(keys: torch.Tensor, n_vertices: int, source: int,
               dist: torch.Tensor, parent: torch.Tensor,
               unreached_at: float) -> Tuple[int, int]:
    """(vertices whose served level differs from the reference's, reached
    vertices whose served parent is not an in-neighbour one level up)."""
    dev = keys.device
    ref = bfs_levels(keys, n_vertices, source)
    dist = dist.to(dev)
    parent = parent.to(dev).long()
    served_reached = dist < unreached_at
    ref_reached = ref >= 0
    level_bad = (served_reached != ref_reached) | (
        ref_reached & (dist.double() != ref.double()))
    v = torch.nonzero(ref_reached & served_reached).flatten()
    v = v[v != source]
    p = parent[v]
    ok = (p >= 0) & (p < n_vertices)
    pc = p.clamp(0, n_vertices - 1)
    ok &= ref[pc] == ref[v] - 1
    want = pc * n_vertices + v
    pos = torch.searchsorted(keys, want).clamp_max(max(keys.numel() - 1, 0))
    ok &= keys.numel() > 0
    if keys.numel():
        ok &= keys[pos] == want
    return int(level_bad.sum()), int((~ok).sum())
