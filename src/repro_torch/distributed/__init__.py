"""The sharded graph plane in its one-device rendering: vertex-partitioned
SlabGraph pools stacked on a shard axis (``sharded_graph``) and the
shard-axis exchanges (``collectives``)."""
from . import collectives, sharded_graph
from .collectives import exchange_buckets, gather_interleaved, \
    or_across_shards
from .sharded_graph import (ShardedSlabGraph, apply_update_sharded,
                            bfs_sharded, delete_edges_sharded,
                            ensure_capacity_sharded, insert_edges_sharded,
                            pagerank_sharded, place_on_mesh,
                            query_edges_sharded, reassemble_global,
                            route_edges, routing_cap, shard_empty,
                            shard_from_edges_host, shard_slice,
                            triangles_sharded, wcc_sharded)

__all__ = ["collectives", "sharded_graph", "exchange_buckets",
           "gather_interleaved", "or_across_shards", "ShardedSlabGraph",
           "apply_update_sharded", "bfs_sharded", "delete_edges_sharded",
           "ensure_capacity_sharded", "insert_edges_sharded",
           "pagerank_sharded", "place_on_mesh", "query_edges_sharded",
           "reassemble_global", "route_edges", "routing_cap", "shard_empty",
           "shard_from_edges_host", "shard_slice", "triangles_sharded",
           "wcc_sharded"]
