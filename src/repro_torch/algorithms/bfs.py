"""Dynamic BFS (paper §4.2, §6.1), in the paper's two variants.

* VANILLA: level-synchronous static BFS with 32-bit levels and no
  dependence tree (the fast static path).
* TREE: the ⟨distance, parent⟩ tree of the SSSP engine with unit weights,
  which supports incremental and decremental updates (paper: "the
  incremental/decremental BFS algorithm uses the same kernels as that of
  incremental/decremental SSSP").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.slab_graph import SlabGraph
from ..core.worklist import expand_vertices
from ..kernels.slab_sweep.ops import sweep_vertices
from .sssp import (INF, TreeState, _expand_frontier, init_state,
                   relax_edges, run_to_convergence, sssp_decremental,
                   sssp_incremental, tree_state_like)

#: the level of a vertex the search has not reached
UNREACHED = 2 ** 30


def bfs_vanilla(g: SlabGraph, *, src: int, edge_capacity: int,
                max_bpv: int = 1, max_iters: int = 100000,
                g_in: Optional[SlabGraph] = None
                ) -> Tuple[torch.Tensor, int]:
    """Level-synchronous static BFS from ``src``: (levels int32, iterations).

    With ``g_in`` (the transpose, ``core.transpose_host(g)``) each level is
    one ``sum`` sweep of the frontier indicator over in-neighbours: no
    vertex compaction, no edge buffer, no ``edge_capacity`` pressure.
    Without it, the frontier's out-edges are expanded (``expand_vertices``)
    into a buffer of ``edge_capacity`` edges; edges past it are dropped, as
    the reference drops them.
    """
    n, dev = g.n_vertices, g.device
    dist = torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
    dist[src] = 0
    newly = torch.zeros(n, dtype=torch.bool, device=dev)
    newly[src] = True
    it = 0
    while it < max_iters and bool(newly.any()):
        if g_in is not None:
            hits = sweep_vertices(g_in, newly.to(torch.int32),
                                  semiring="sum")
            touched = hits > 0
        else:
            ef = _expand_frontier(g, newly, edge_capacity=edge_capacity,
                                  max_bpv=max_bpv)
            emask = torch.arange(edge_capacity, device=dev) < ef.size
            d = torch.where(emask & (ef.dst >= 0) & (ef.dst < n), ef.dst, n)
            touched = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            touched[d.long()] = True
            touched = touched[:n]
        newly = touched & (dist == UNREACHED)
        dist = torch.where(newly, it + 1, dist)
        it += 1
    return dist, it


def bfs_tree_static(g: SlabGraph, src: int, *, edge_capacity: int,
                    max_bpv: int = 1, g_in: Optional[SlabGraph] = None
                    ) -> Tuple[TreeState, int]:
    """Static tree BFS from ``src``: (state, iterations)."""
    state = init_state(g.n_vertices, src, g.device)
    improved = torch.zeros(g.n_vertices, dtype=torch.bool, device=g.device)
    improved[src] = True
    return run_to_convergence(g, state, improved,
                              edge_capacity=edge_capacity, max_bpv=max_bpv,
                              g_in=g_in)


def bfs_incremental(g: SlabGraph, state: TreeState, bsrc, bdst, bmask, *,
                    edge_capacity: int, max_bpv: int = 1, g_in=None):
    """Unit-weight incremental update through the SSSP engine."""
    bw = torch.ones(bsrc.shape[0], dtype=torch.float32, device=bsrc.device)
    return sssp_incremental(g, state, bsrc, bdst, bw, bmask,
                            edge_capacity=edge_capacity, max_bpv=max_bpv,
                            g_in=g_in)


def bfs_decremental(g: SlabGraph, state: TreeState, bsrc, bdst, bmask, *,
                    src: int, edge_capacity: int, max_bpv: int = 1,
                    g_in=None):
    return sssp_decremental(g, state, bsrc, bdst, bmask, src=src,
                            edge_capacity=edge_capacity, max_bpv=max_bpv,
                            g_in=g_in)


def stream_property(src: int, *, edge_capacity: int, max_bpv: int = 1):
    """PropertySpec: the BFS tree from ``src``, maintained with the
    decremental then incremental SSSP engine on an unweighted store; the
    convergence loop sweeps the store's transpose view.  On a weighted
    store register ``sssp.stream_property`` instead."""
    from ..stream.properties import PropertySpec

    def _init(store):
        if store.weighted:
            raise ValueError("the bfs stream property needs an unweighted "
                             "GraphStore")
        state, _ = bfs_tree_static(store.forward, src,
                                   edge_capacity=edge_capacity,
                                   max_bpv=max_bpv, g_in=store.transpose)
        return state

    def _on_batch(store, state, batch):
        if batch.del_src is not None:
            state, _ = bfs_decremental(store.forward, state, batch.del_src,
                                       batch.del_dst, batch.del_mask,
                                       src=src, edge_capacity=edge_capacity,
                                       max_bpv=max_bpv, g_in=store.transpose)
        if batch.ins_src is not None:
            state, _ = bfs_incremental(store.forward, state, batch.ins_src,
                                       batch.ins_dst, batch.ins_mask,
                                       edge_capacity=edge_capacity,
                                       max_bpv=max_bpv, g_in=store.transpose)
        return state

    return PropertySpec(name=f"bfs_{src}", init=_init, on_batch=_on_batch,
                        refresh=_init, state_like=tree_state_like)
