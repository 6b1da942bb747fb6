"""k-hop fanout neighbour sampler (GraphSAGE-style) for ``minibatch_lg``,
from ``repro.data.sampler``: the port's own copy of the reference's host
numpy, so the same ``seed`` gives the same arrays bit for bit.

Host-side over a CSR snapshot, producing fixed-shape padded subgraph
batches.  The CSR can be a static graph's or a live SlabGraph's
(``core.worklist.csr_snapshot``, moved to the host): sampling over the
dynamic structure.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def build_csr(n_vertices: int, src: np.ndarray, dst: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.add.at(indptr, s.astype(np.int64) + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, d.astype(np.int32)


def sample_khop(indptr: np.ndarray, indices: np.ndarray,
                seeds: np.ndarray, fanout: Sequence[int], *,
                seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fanout sampling with fixed output shapes (padded):

    Returns (nodes, senders, receivers, edge_mask) where
      nodes    : (B (1 + f1 + f1 f2 + ...),) int32, the layer-wise
                 frontier ids, padded with repeats of node 0;
      senders/receivers index into the global id space (the model gathers
      features by global id), edge_mask marks real sampled edges.
    """
    rng = np.random.default_rng(seed)
    layers = [seeds.astype(np.int64)]
    edges_s, edges_r, emask = [], [], []
    frontier = seeds.astype(np.int64)
    for f in fanout:
        deg = indptr[frontier + 1] - indptr[frontier]
        # f samples per frontier node, with replacement; degree 0 -> masked
        offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                            size=(len(frontier), f))
        nbr = indices[np.minimum(indptr[frontier][:, None] + offs,
                                 len(indices) - 1)]
        ok = (deg > 0)[:, None] & np.ones((1, f), bool)
        edges_s.append(np.where(ok, nbr, 0).reshape(-1))
        edges_r.append(np.repeat(frontier, f))
        emask.append(ok.reshape(-1))
        frontier = np.where(ok, nbr, 0).reshape(-1).astype(np.int64)
        layers.append(frontier)

    nodes = np.concatenate(layers).astype(np.int32)
    return (nodes,
            np.concatenate(edges_s).astype(np.int32),
            np.concatenate(edges_r).astype(np.int32),
            np.concatenate(emask))
