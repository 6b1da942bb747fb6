"""Lossless numpy bridge for SlabGraph state.

One numpy array per ``SlabGraph`` field, in and out.  Keys travel as int32
bit patterns; a uint32 key array (the reference's dtype) is accepted and
viewed as int32 on the way in.  The metadata follows from the arrays:
``n_vertices = len(bucket_count)``, ``n_buckets = len(bucket_vertex)``,
``weighted = weights is not None``.  The tests start the port from a pool
of the reference through here and compare pools leaf for leaf.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .slab_graph import FIELDS, SlabGraph

_BOOL_FIELDS = ("upd_flag", "slab_new")


def _host(name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if name == "keys" and a.dtype == np.uint32:
        return a.view(np.int32)
    dtype = (np.float32 if name == "weights" else
             bool if name in _BOOL_FIELDS else np.int32)
    return a.astype(dtype, copy=False)


def slab_graph_from_numpy(fields: Dict[str, Optional[np.ndarray]],
                          device) -> SlabGraph:
    """SlabGraph on ``device`` from one numpy array per field (copied: the
    graph never shares memory with the caller's arrays)."""
    dev = resolve_device(device)
    tensors = {}
    for name in FIELDS:
        a = fields[name]
        tensors[name] = (None if a is None else
                         torch.tensor(_host(name, a), device=dev))
    return SlabGraph(**tensors,
                     n_vertices=int(np.asarray(fields["bucket_count"]).size),
                     n_buckets=int(np.asarray(fields["bucket_vertex"]).size),
                     weighted=fields["weights"] is not None)


def slab_graph_to_numpy(g: SlabGraph) -> Dict[str, Optional[np.ndarray]]:
    """One numpy array per field (keys as int32 bit patterns)."""
    return {name: (None if getattr(g, name) is None
                   else getattr(g, name).detach().cpu().numpy())
            for name in FIELDS}
