"""Pooled slab-hash dynamic graph and its iteration primitives, as torch
tensors (uint32 keys kept as int32 bit patterns; see ``hashing``).

The batched update entry points (``core.batch``) are re-exported lazily:
they live in ``kernels/slab_update``, which imports this package."""
from .bridge import slab_graph_from_numpy, slab_graph_to_numpy
from .device import resolve_device, resolve_impl
from .hashing import (EMPTY_KEY, INVALID_LANE, INVALID_SLAB, INVALID_VERTEX,
                      SLAB_WIDTH, TOMBSTONE_KEY, bucket_hash,
                      is_valid_vertex)
from .slab_graph import (SlabGraph, empty, ensure_capacity, from_edges_host,
                         next_pow2, plan_buckets, pool_stats,
                         update_slab_pointers)
from .worklist import (CSR, EdgeFrontier, PoolView, csr_snapshot,
                       expand_vertices, occupancy_stats, pool_edges,
                       transpose_host, updated_lane_mask, updated_vertices)
from .frontier import Frontier, clear, enqueue, make_frontier, swap
from .union_find import (component_labels, compress, count_components, find,
                         init_parents, union_batch)
from .iterators import bucket_iterator, slab_iterator, update_iterator

_BATCH = ("apply_update", "delete_edges", "insert_edges", "query_edges",
          "probe", "update_views")


def __getattr__(name):
    if name in _BATCH:
        from . import batch
        return getattr(batch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "slab_graph_from_numpy", "slab_graph_to_numpy",
    "resolve_device", "resolve_impl", "EMPTY_KEY", "INVALID_LANE",
    "INVALID_SLAB", "INVALID_VERTEX", "SLAB_WIDTH", "TOMBSTONE_KEY",
    "bucket_hash", "is_valid_vertex", "SlabGraph", "empty",
    "ensure_capacity", "from_edges_host", "next_pow2", "plan_buckets",
    "pool_stats", "update_slab_pointers", *_BATCH,
    "CSR", "EdgeFrontier", "PoolView", "csr_snapshot", "expand_vertices",
    "occupancy_stats", "pool_edges", "transpose_host", "updated_lane_mask",
    "updated_vertices",
    "Frontier", "clear", "enqueue", "make_frontier", "swap",
    "component_labels", "compress", "count_components", "find",
    "init_parents", "union_batch",
    "bucket_iterator", "slab_iterator", "update_iterator",
]
