"""Slab-sweep engine: SlabGraph in, per-slab partials or per-vertex out.

``sweep_partials`` runs the semiring sweep over the pool (the kernel on the
card); ``sweep_vertices`` folds the partials per owner vertex with a
segment reduction keyed by ``slab_vertex``.  Together they are the
super-step of PageRank (sum), WCC label propagation (min) and SSSP/BFS
relaxation (min_plus, arg_min_plus).

The fold is plain tensor code, as it is outside any kernel in the
reference.  The min family is exact; a float ``sum`` adds in another order
than the reference (and, on the card, in the order its atomics land).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...core.device import resolve_impl
from ...core.slab_graph import SlabGraph
from ...obs.instrument import timed_dispatch
from .kernel import slab_sweep
from .ref import SEMIRINGS, INT32_MAX, slab_sweep_ref


def _slice_rows(g: SlabGraph, rows: Optional[int]) -> SlabGraph:
    """Bound the sweep to the first ``rows`` pool rows, a host-known bound on
    the allocated prefix; rows past it hold no live key, so every result is
    unchanged."""
    if rows is None or rows >= g.capacity_slabs:
        return g
    return dataclasses.replace(
        g, keys=g.keys[:rows], slab_vertex=g.slab_vertex[:rows],
        weights=None if g.weights is None else g.weights[:rows])


@timed_dispatch("slab_sweep")
def sweep_partials(g: SlabGraph, values: torch.Tensor, *, semiring: str,
                   frontier: Optional[torch.Tensor] = None,
                   target: Optional[torch.Tensor] = None,
                   weighted: Optional[bool] = None,
                   n_keys: Optional[int] = None, impl: str = "auto",
                   rows: Optional[int] = None) -> torch.Tensor:
    """(S,) semiring partials over the pool.

    ``frontier`` (V,) bool over key vertices (None = all); ``target`` for
    ``arg_min_plus`` is per vertex (V,) and is gathered to the rows here.
    ``weighted`` defaults to the weight pool for the ``*_plus`` semirings on
    weighted graphs; ``n_keys`` bounds lane-key validity (default
    ``g.n_vertices``); ``rows`` bounds the sweep to the allocated prefix.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    resolve_impl(impl, g.keys)
    g = _slice_rows(g, rows)
    if weighted is None:
        weighted = g.weighted and semiring in ("min_plus", "arg_min_plus")
    if target is not None:
        target = target[g.slab_vertex.clamp_min(0).long()]
    return slab_sweep(g.keys, g.slab_vertex, values,
                      g.weights if weighted else None, frontier, target,
                      semiring=semiring,
                      n_vertices=g.n_vertices if n_keys is None else n_keys)


@timed_dispatch("slab_sweep")
def sweep_vertices(g: SlabGraph, values: torch.Tensor, *, semiring: str,
                   frontier: Optional[torch.Tensor] = None,
                   target: Optional[torch.Tensor] = None,
                   weighted: Optional[bool] = None,
                   n_keys: Optional[int] = None, impl: str = "auto",
                   rows: Optional[int] = None) -> torch.Tensor:
    """(V,) per-vertex reduction: the partials folded over ``slab_vertex``.

    The result lands at the slab owner (pull direction): sweep the
    transpose for push-style relaxations.  A vertex with no slab gets 0
    (sum) or the fold's identity (inf for float, INT32_MAX for int32), as
    the reference's ``segment_sum``/``segment_min`` give.
    """
    g = _slice_rows(g, rows)
    partials = sweep_partials(g, values, semiring=semiring,
                              frontier=frontier, target=target,
                              weighted=weighted, n_keys=n_keys, impl=impl)
    n = g.n_vertices
    seg = torch.where(g.slab_vertex >= 0, g.slab_vertex, n).long()
    if semiring == "sum":
        out = torch.zeros(n + 1, dtype=partials.dtype, device=g.device)
        return out.index_add_(0, seg, partials)[:n]
    fill = (float("inf") if partials.dtype.is_floating_point
            else INT32_MAX)
    out = torch.full((n + 1,), fill, dtype=partials.dtype, device=g.device)
    return out.scatter_reduce_(0, seg, partials, "amin",
                               include_self=True)[:n]


__all__ = ["sweep_partials", "sweep_vertices", "slab_sweep",
           "slab_sweep_ref", "SEMIRINGS"]
