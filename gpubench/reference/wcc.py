"""Plain reference weak components, labelled by their least vertex id.
Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .edges import split


def components(keys: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """Weak components labelled by their least vertex id: min-label
    propagation over both directions of every edge, with pointer jumps."""
    V = n_vertices
    src, dst = split(keys, V)
    lab = torch.arange(V, dtype=torch.long, device=keys.device)
    while True:
        m = torch.minimum(lab[src], lab[dst])
        new = lab.clone()
        new.scatter_reduce_(0, src, m, "amin")
        new.scatter_reduce_(0, dst, m, "amin")
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


def label_errors(served: torch.Tensor, ref: torch.Tensor) -> int:
    return int((served.to(ref.device).long() != ref).sum())
