"""The serving loop: a versioned multi-view GraphStore (and its sharded
rendering, ShardedGraphStore), an incremental property registry over it
and a batched request pipeline."""
from .maintenance import (COMPACT, RECLAIM, MaintenancePolicy,
                          MaintenanceRecord)
from .properties import EAGER, LAZY, PropertyRegistry, PropertySpec
from .requests import (MembershipQuery, NeighborsQuery, PropertyRead, Request,
                       RequestPipeline, Response, UpdateBatch,
                       coalesce_updates)
from .sharded_store import (ShardedGraphStore, sharded_bfs_property,
                            sharded_pagerank_property, sharded_triangle_property,
                            sharded_wcc_property)
from .store import (ALL_VIEWS, FORWARD, SYMMETRIC, TRANSPOSE, AppliedBatch,
                    GraphStore, canonical_batch, dedup_pairs)

__all__ = [
    "ALL_VIEWS", "FORWARD", "SYMMETRIC", "TRANSPOSE", "AppliedBatch",
    "GraphStore", "canonical_batch", "dedup_pairs", "EAGER", "LAZY",
    "PropertyRegistry", "PropertySpec", "MembershipQuery", "NeighborsQuery",
    "PropertyRead", "Request", "RequestPipeline", "Response", "UpdateBatch",
    "coalesce_updates", "COMPACT", "RECLAIM", "MaintenancePolicy",
    "MaintenanceRecord", "ShardedGraphStore", "sharded_bfs_property",
    "sharded_pagerank_property", "sharded_triangle_property",
    "sharded_wcc_property",
]
