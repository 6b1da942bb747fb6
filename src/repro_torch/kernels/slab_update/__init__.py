"""Slab-update engine: chain-walk probe and commit kernels, run-local
placement (see ``ops``)."""
from .kernel import slab_commit, slab_commit_torch, slab_probe, \
    slab_probe_torch
from .ops import (FORWARD, SYMMETRIC, TRANSPOSE, apply_update, delete_edges,
                  insert_edges, query_edges, update_views)
from .ref import batch_valid, edge_buckets, probe

__all__ = ["slab_commit", "slab_commit_torch", "slab_probe",
           "slab_probe_torch", "FORWARD", "SYMMETRIC", "TRANSPOSE",
           "apply_update", "delete_edges", "insert_edges", "query_edges",
           "update_views", "batch_valid", "edge_buckets", "probe"]
