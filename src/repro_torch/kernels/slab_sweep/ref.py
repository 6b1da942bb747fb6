"""Plain PyTorch version of the semiring slab sweep.

One pass over the (S, 128) pool: gather a per-vertex value at every lane
key, combine under the semiring, mask lanes by validity and the optional
frontier, reduce the 128 lanes to one partial per slab row.

  * ``sum``          values[key] (x weight when given);  reduce +
  * ``min``          values[key];                         reduce min
  * ``min_plus``     values[key] + weight (1 unweighted); reduce min
  * ``arg_min_plus`` key where values[key] + weight <= target (per row);
                     reduce min, int32 output

Lanes whose key is not a vertex (``0 <= key < n`` fails: the sentinels and
ids at or above ``2**31``), rows with a negative owner and lanes whose key
is outside ``frontier`` contribute the semiring identity.  Integer values
take no weights.
"""
from __future__ import annotations

from typing import Optional

import torch

SEMIRINGS = ("sum", "min", "min_plus", "arg_min_plus")

INT32_MAX = 2 ** 31 - 1


def semiring_identity(semiring: str, dtype: torch.dtype):
    """Reduction identity: 0 for sum, the dtype's max for the min family
    (INT32_MAX for arg_min_plus)."""
    if semiring == "sum":
        return 0
    if semiring == "arg_min_plus":
        return INT32_MAX
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


def slab_sweep_ref(keys: torch.Tensor, slab_vertex: torch.Tensor,
                   values: torch.Tensor, *, semiring: str, n_vertices: int,
                   weights: Optional[torch.Tensor] = None,
                   frontier: Optional[torch.Tensor] = None,
                   target: Optional[torch.Tensor] = None) -> torch.Tensor:
    """keys (S, 128) int32, slab_vertex (S,) int32, values (V,) -> (S,).

    ``weights`` (S, 128) float32, ``frontier`` (V,) bool over key vertices,
    ``target`` (S,) the per-row reference of ``arg_min_plus``.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if weights is not None and not values.dtype.is_floating_point:
        raise ValueError("integer values take no weights")
    valid = (keys >= 0) & (keys < n_vertices) & (slab_vertex[:, None] >= 0)
    idx = torch.where(valid, keys, 0).long()
    if frontier is not None:
        valid = valid & (frontier[idx] != 0)
    vals = values[idx]

    if semiring == "sum":
        if weights is not None:
            vals = vals * weights
        return torch.where(valid, vals, 0).sum(dim=1, dtype=values.dtype)
    ident = semiring_identity(semiring, values.dtype)
    if semiring == "min":
        return torch.where(valid, vals, ident).amin(dim=1)
    cand = vals + (weights if weights is not None else 1)
    if semiring == "min_plus":
        return torch.where(valid, cand, ident).amin(dim=1)
    if target is None:
        raise ValueError("arg_min_plus requires a per-slab target")
    at_min = valid & (cand <= target[:, None])
    return torch.where(at_min, keys, INT32_MAX).amin(dim=1)
