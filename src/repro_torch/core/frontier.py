"""Frontier<T>: a fixed-capacity work queue with prefix-sum enqueue.

``warpenqueuefrontier`` (paper Alg. 2) is ballot, popc, one aggregated
``atomicAdd`` and a positional write per lane.  Here the ballot and popc
pair is an exclusive prefix sum over the participation mask and the atomic
base is the carried ``size``, so an enqueue is a deterministic masked
compaction.  Capacity is fixed; writes past it are dropped and flagged, and
the caller grows the buffer between steps.  Every operation returns a new
``Frontier`` and leaves its argument as it was, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class Frontier:
    data: torch.Tensor      # (cap, k): k fields per element (e.g. src, dst, w)
    size: torch.Tensor      # () int32
    overflow: torch.Tensor  # () bool

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def make_frontier(capacity: int, n_fields: int, dtype=torch.float32, *,
                  device="cuda") -> Frontier:
    """An empty queue of ``capacity`` elements on ``device`` (``cuda``
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return Frontier(
        data=torch.zeros((capacity, n_fields), dtype=dtype, device=dev),
        size=torch.zeros((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev))


def clear(f: Frontier) -> Frontier:
    return dataclasses.replace(f, size=torch.zeros_like(f.size),
                               overflow=torch.zeros_like(f.overflow))


def enqueue(f: Frontier, values: torch.Tensor,
            mask: torch.Tensor) -> Frontier:
    """Append ``values[mask]`` in order (``values`` (n, k), ``mask`` (n,)).
    Writes past capacity are dropped and set ``overflow``; ``size`` stops
    at capacity."""
    m = mask.to(torch.int32)
    pos = f.size + torch.cumsum(m, 0, dtype=torch.int32) - m
    keep = mask & (pos < f.capacity)
    data = f.data.clone()
    data[pos[keep].long()] = values[keep].to(f.data.dtype)
    new_size = f.size + m.sum(dtype=torch.int32)
    return Frontier(data=data, size=torch.clamp(new_size, max=f.capacity),
                    overflow=f.overflow | (new_size > f.capacity))


def swap(a: Frontier, b: Frontier) -> Tuple[Frontier, Frontier]:
    """The paper's ``swap(F_current, F_next)``: (new current, cleared
    next)."""
    return b, clear(a)
