"""Neighbourhood-intersection engine: the triangle-counting plane (Alg. 9),
with the intersection-count and membership-probe kernels (see ``ops``)."""
from .kernel import probe_hits, probe_hits_torch, slab_count, \
    slab_count_torch
from .ops import (IMPLS, adjacency_rows, count_edges, count_edges_local,
                  count_shards, materialize_chains, search_edges_kernel)
from .ref import count_edges_ref, probe_hits_ref, search_edges_ref

__all__ = ["IMPLS", "count_edges", "count_edges_local", "count_shards",
           "adjacency_rows", "materialize_chains",
           "search_edges_kernel", "slab_count", "slab_count_torch",
           "probe_hits", "probe_hits_torch", "count_edges_ref",
           "probe_hits_ref", "search_edges_ref"]
