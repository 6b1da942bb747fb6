"""The sharded graph plane: vertex-partitioned SlabGraph pools
(``sharded_graph``), the shard-axis exchanges (``collectives``) and the
processes of the multi-process rendering (``ranks``).  Two renderings
with equal pools leaf for leaf: every shard stacked on one device, or one
shard a process on a ``("shard",)`` mesh (``place_on_mesh``), its
exchanges ``torch.distributed`` collectives."""
from . import collectives, ranks, sharded_graph
from .collectives import exchange_buckets, gather_interleaved, \
    or_across_shards
from .ranks import RankGroup, close_shard_mesh, init_shard_mesh
from .sharded_graph import (ShardedSlabGraph, apply_update_sharded,
                            bfs_sharded, delete_edges_sharded,
                            ensure_capacity_sharded, insert_edges_sharded,
                            pagerank_sharded, place_on_mesh,
                            query_edges_sharded, reassemble_global,
                            route_edges, route_exchange, routing_cap,
                            shard_empty, shard_from_edges_host, shard_slice,
                            triangles_sharded, wcc_sharded)

__all__ = ["collectives", "ranks", "sharded_graph", "exchange_buckets",
           "gather_interleaved", "or_across_shards", "RankGroup",
           "close_shard_mesh", "init_shard_mesh", "ShardedSlabGraph",
           "apply_update_sharded", "bfs_sharded", "delete_edges_sharded",
           "ensure_capacity_sharded", "insert_edges_sharded",
           "pagerank_sharded", "place_on_mesh", "query_edges_sharded",
           "reassemble_global", "route_edges", "route_exchange",
           "routing_cap", "shard_empty", "shard_from_edges_host",
           "shard_slice", "triangles_sharded", "wcc_sharded"]
