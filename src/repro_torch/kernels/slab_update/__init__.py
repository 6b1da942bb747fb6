"""Slab-update engine: chain-walk probe and commit kernels, run-local
placement (see ``ops``), and the whole-pool oracle it reproduces
(``ref``)."""
from .kernel import slab_commit, slab_commit_torch, slab_probe, \
    slab_probe_torch
from .ops import (FORWARD, IMPLS, SYMMETRIC, TRANSPOSE, apply_update,
                  delete_edges, delete_edges_local, insert_edges,
                  insert_edges_local, query_edges, query_edges_local,
                  query_shards, update_shards, update_views)
from .ref import (batch_valid, delete_edges_ref, edge_buckets,
                  insert_edges_ref, probe, query_edges_ref)

__all__ = ["IMPLS", "slab_commit", "slab_commit_torch", "slab_probe",
           "slab_probe_torch", "FORWARD", "SYMMETRIC", "TRANSPOSE",
           "apply_update", "delete_edges", "insert_edges", "query_edges",
           "update_views", "query_edges_local", "insert_edges_local",
           "delete_edges_local", "update_shards", "query_shards",
           "batch_valid", "delete_edges_ref",
           "edge_buckets", "insert_edges_ref", "probe", "query_edges_ref"]
