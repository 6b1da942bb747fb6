"""Batched edge insert, delete and query on the SlabGraph.

The entry points of the slab-update engine (``kernels/slab_update``): a
deterministic sort and prefix-scan placement whose pools are bit-identical
to the reference's, with the chain-walk probe and the commit as CUDA
kernels on the card.  Batches are int32 key bit patterns padded with
INVALID_VERTEX (-1); invalid lanes are rejected before they probe.
"""
from __future__ import annotations

from ..kernels.slab_update.ops import (apply_update, delete_edges,
                                       insert_edges, query_edges,
                                       query_shards, update_shards,
                                       update_views)
from ..kernels.slab_update.ref import (batch_valid, delete_edges_ref,
                                       edge_buckets, insert_edges_ref, probe,
                                       query_edges_ref, sort_by_bucket)

__all__ = ["apply_update", "delete_edges", "insert_edges", "query_edges",
           "query_shards", "update_shards", "update_views", "batch_valid",
           "edge_buckets", "probe", "delete_edges_ref", "insert_edges_ref",
           "query_edges_ref", "sort_by_bucket"]
