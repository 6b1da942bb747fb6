"""Edge generators of the configurations, drawn from a seed.

The arithmetic is the port's ``data/synth.py`` (R-MAT bits per level,
uniform draws, self-loops dropped), written here with a ``torch.Generator``
so that the benchmark's yardstick does not move when the program does.
As GAP's generator does, a Kronecker graph's vertex ids are relabelled by
a permutation drawn from the graph's seed (``permute``), and a graph that
GAP symmetrises (``symmetric``) holds every edge in both directions.
Edges are int64 keys ``src * V + dst``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rmat(gen: torch.Generator, n: int, scale: int, *, a: float, b: float,
         c: float) -> torch.Tensor:
    """``n`` R-MAT draws over ``2**scale`` vertices (self-loops kept)."""
    dev = gen.device
    src = torch.zeros(n, dtype=torch.long, device=dev)
    dst = torch.zeros(n, dtype=torch.long, device=dev)
    for _ in range(scale):
        r = torch.rand(n, generator=gen, device=dev)
        src_bit = (r >= a + b).long()
        r2 = torch.rand(n, generator=gen, device=dev)
        dst_bit = torch.where(src_bit == 0, (r2 >= a / (a + b)).long(),
                              (r2 >= c / (c + (1 - a - b - c) + 1e-12)).long())
        src = src * 2 + src_bit
        dst = dst * 2 + dst_bit
    return src * (1 << scale) + dst


def uniform(gen: torch.Generator, n: int, scale: int) -> torch.Tensor:
    """``n`` uniform draws over ``2**scale`` vertices (self-loops kept)."""
    V = 1 << scale
    src = torch.randint(0, V, (n,), generator=gen, device=gen.device)
    dst = torch.randint(0, V, (n,), generator=gen, device=gen.device)
    return src * V + dst


def draw(gen: torch.Generator, graph: dict, n: int) -> torch.Tensor:
    """``n`` draws of the configuration's generator, self-loops dropped
    (ids as drawn, before any relabelling)."""
    scale = int(graph["scale"])
    kind = graph["generator"]
    if kind == "rmat":
        keys = rmat(gen, n, scale, a=graph["a"], b=graph["b"], c=graph["c"])
    elif kind == "uniform":
        keys = uniform(gen, n, scale)
    else:
        raise ValueError(f"unknown generator {kind!r}")
    V = 1 << scale
    return keys[keys // V != keys % V]


def draw_exactly(gen: torch.Generator, graph: dict, n: int) -> torch.Tensor:
    """Exactly ``n`` draws without self-loops: the first ``n`` of a few
    more, drawn again in the rare case that too many were loops."""
    extra = n // 64 + 64
    while True:
        keys = draw(gen, graph, n + extra)
        if keys.numel() >= n:
            return keys[:n]
        extra *= 4


def relabel(keys: torch.Tensor, perm: Optional[torch.Tensor],
            V: int) -> torch.Tensor:
    """Both ends of each key through ``perm`` (none: unchanged)."""
    if perm is None:
        return keys
    perm = perm.to(keys.device)
    return perm[keys // V] * V + perm[keys % V]


def reverse(keys: torch.Tensor, V: int) -> torch.Tensor:
    """Each edge turned round."""
    return (keys % V) * V + keys // V


def canonical(keys: torch.Tensor, V: int) -> torch.Tensor:
    """Each edge as ``min * V + max`` of its ends."""
    return torch.minimum(keys, reverse(keys, V))


def initial_edges(gen: torch.Generator, graph: dict
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The configuration's initial edge list and its id permutation:
    ``edge_factor * V`` draws, self-loops dropped, relabelled where the
    configuration permutes, both directions where it is symmetric,
    duplicates dropped, sorted by key."""
    V = 1 << int(graph["scale"])
    keys = draw(gen, graph, int(graph["edge_factor"]) * V)
    perm = None
    if graph["permute"]:
        perm = torch.randperm(V, generator=gen, device=gen.device)
        keys = relabel(keys, perm, V)
    if graph["symmetric"]:
        keys = torch.cat([keys, reverse(keys, V)])
    return torch.unique(keys), perm
