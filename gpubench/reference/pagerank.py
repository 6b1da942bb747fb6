"""Plain reference PageRank: power iteration over the out-edges, in any
dtype (float64 to a tight tolerance for the check, the precision below the
configuration's for the control).  Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .edges import split


def pagerank(keys: torch.Tensor, n_vertices: int, *, damping: float,
             tol: float, max_iter: int, dtype=torch.float64) -> torch.Tensor:
    """Power iteration from the uniform vector: each vertex's rank split
    over its out-edges, sinks' rank teleported uniformly, until the L1
    change is at most ``tol`` (in ``dtype``) or ``max_iter`` steps."""
    V = n_vertices
    src, dst = split(keys, V)
    dev = keys.device
    outdeg = torch.bincount(src, minlength=V)
    has_out = outdeg > 0
    deg = outdeg.clamp_min(1).to(dtype)
    pr = torch.full((V,), 1.0 / V, dtype=dtype, device=dev)
    for _ in range(max_iter):
        contrib = torch.where(has_out, pr / deg, torch.zeros((), dtype=dtype,
                                                              device=dev))
        sums = torch.zeros(V, dtype=dtype, device=dev).index_add_(
            0, dst, contrib[src])
        sink = torch.where(has_out, torch.zeros((), dtype=dtype, device=dev),
                           pr).sum()
        new = (1.0 - damping) / V + damping * (sums + sink / V)
        change = (new - pr).abs().sum()
        pr = new
        if bool(change <= tol):
            break
    return pr


def pagerank_l1(served: torch.Tensor, ref: torch.Tensor) -> float:
    return float((served.to(ref.device).double() - ref.double()).abs().sum())
