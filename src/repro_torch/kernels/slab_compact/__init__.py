"""Slab compaction: the live-census and chain-rank kernels, their plain
versions, the sort-based oracle and the engine (see ``ops``)."""
from .kernel import chain_rank, chain_rank_torch, slab_live, slab_live_torch
from .ops import (IMPLS, CompactionReport, compact, compact_shards,
                  reclaim_free_slabs, reclaim_shards)
from .ref import chain_order, compact_ref, live_lane_mask

__all__ = ["chain_rank", "chain_rank_torch", "slab_live", "slab_live_torch",
           "IMPLS", "CompactionReport", "compact", "compact_shards",
           "reclaim_free_slabs", "reclaim_shards",
           "chain_order", "compact_ref", "live_lane_mask"]
