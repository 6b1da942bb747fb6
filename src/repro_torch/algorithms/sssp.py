"""Dynamic single-source shortest paths on the ⟨distance, parent⟩ tree.

The reference (``repro.algorithms.sssp``) keeps the paper's 64-bit packed
``atomicMin`` as two planes with a lexicographic minimum: ties break toward
the smaller parent id.  Incremental updates seed the frontier with the
inserted batch; decremental ones invalidate the subtrees under deleted tree
edges (pointer doubling), re-seed from every surviving-to-invalidated edge
and converge the same way.  The reference's ``while_loop``s are Python loops
here; each convergence step asks the host whether any vertex improved.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.slab_graph import SlabGraph
from ..core.worklist import EdgeFrontier, expand_vertices, pool_edges
from ..kernels.slab_sweep.ops import sweep_vertices

INF = 1e30
NO_PARENT = -1
_INT32_MAX = 2 ** 31 - 1
#: pool rows per chunk of the decremental re-seeding scan (8M lanes)
_SCAN_ROWS = 1 << 16


class TreeState(NamedTuple):
    dist: torch.Tensor    # (V,) float32
    parent: torch.Tensor  # (V,) int32


def init_state(n_vertices: int, src: int, device) -> TreeState:
    """All INF / NO_PARENT except the source (distance 0, its own parent)."""
    dist = torch.full((n_vertices,), INF, dtype=torch.float32, device=device)
    parent = torch.full((n_vertices,), NO_PARENT, dtype=torch.int32,
                        device=device)
    dist[src] = 0.0
    parent[src] = src
    return TreeState(dist, parent)


def _apply_relax(state: TreeState, dmin, pmin) -> Tuple[TreeState,
                                                        torch.Tensor]:
    improved = (dmin < state.dist) | ((dmin == state.dist)
                                      & (pmin < state.parent) & (dmin < INF))
    return TreeState(torch.where(improved, dmin, state.dist),
                     torch.where(improved, pmin, state.parent)), improved


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int, fill):
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amin", include_self=True)[:n]


def relax_edges(state: TreeState, esrc: torch.Tensor, edst: torch.Tensor,
                ew: torch.Tensor, emask: torch.Tensor
                ) -> Tuple[TreeState, torch.Tensor]:
    """One batched relaxation over an edge list; returns (state, improved).
    Lexicographic ⟨distance, parent⟩ minimum by two segment minima."""
    n = state.dist.shape[0]
    s = torch.where(emask, esrc, 0).long()
    # destinations outside [0, n) land in the dropped segment n, as the
    # reference's segment_min drops out-of-range segment ids
    d = torch.where(emask & (edst >= 0) & (edst < n), edst, n).long()
    cand = torch.where(emask, state.dist[s] + ew, INF)
    dmin = _segment_min(cand, d, n, float("inf"))
    at_min = emask & (cand <= dmin[d.clamp(max=n - 1)]) & (d < n)
    pcand = torch.where(at_min, s.to(torch.int32), _INT32_MAX)
    pmin = _segment_min(pcand, d, n, _INT32_MAX)
    return _apply_relax(state, dmin, pmin)


def relax_sweep(g_in: SlabGraph, state: TreeState, frontier: torch.Tensor
                ) -> Tuple[TreeState, torch.Tensor]:
    """One relaxation through the slab sweep on the in-edge graph: min_plus
    for the distance plane, arg_min_plus for the parent tie-break."""
    dmin = sweep_vertices(g_in, state.dist, semiring="min_plus",
                          frontier=frontier)
    pmin = sweep_vertices(g_in, state.dist, semiring="arg_min_plus",
                          frontier=frontier, target=dmin)
    return _apply_relax(state, dmin, pmin)


def _expand_frontier(g: SlabGraph, mask: torch.Tensor, *,
                     edge_capacity: int, max_bpv: int = 1) -> EdgeFrontier:
    """The current out-edges of the vertices set in ``mask``: the
    reference's ``_compact_vertices`` (the warpenqueuefrontier analogue),
    then ``expand_vertices``.  The reference pads the compacted vertices to
    (V,) and masks the tail, which emits nothing, so only the set vertices
    are passed."""
    verts = torch.nonzero(mask).reshape(-1).to(torch.int32)
    return expand_vertices(g, verts, torch.ones_like(verts, dtype=torch.bool),
                           out_capacity=edge_capacity, max_bpv=max_bpv)


def run_to_convergence(g: SlabGraph, state: TreeState,
                       improved0: torch.Tensor, *, edge_capacity: int,
                       max_bpv: int = 1, max_iters: int = 100000,
                       g_in: Optional[SlabGraph] = None
                       ) -> Tuple[TreeState, int]:
    """Relax the frontier ``improved0`` until it empties; (state,
    iterations).

    With ``g_in`` (the transpose) every step is two frontier-masked sweeps;
    without it, the frontier's out-edges are expanded and relaxed as an
    edge list.
    """
    it, improved = 0, improved0
    while it < max_iters and bool(improved.any()):
        if g_in is not None:
            state, improved = relax_sweep(g_in, state, improved)
        else:
            ef = _expand_frontier(g, improved, edge_capacity=edge_capacity,
                                  max_bpv=max_bpv)
            emask = torch.arange(edge_capacity, device=g.device) < ef.size
            w = ef.weight if g.weighted else torch.ones_like(ef.weight)
            state, improved = relax_edges(state, ef.src, ef.dst, w, emask)
        it += 1
    return state, it


def sssp_static(g: SlabGraph, src: int, *, edge_capacity: int,
                max_bpv: int = 1, g_in: Optional[SlabGraph] = None
                ) -> Tuple[TreeState, int]:
    """Seed with the source, iterate to convergence."""
    state = init_state(g.n_vertices, src, g.device)
    improved = torch.zeros(g.n_vertices, dtype=torch.bool, device=g.device)
    improved[src] = True
    return run_to_convergence(g, state, improved,
                              edge_capacity=edge_capacity, max_bpv=max_bpv,
                              g_in=g_in)


def sssp_incremental(g: SlabGraph, state: TreeState, bsrc, bdst, bw, bmask,
                     *, edge_capacity: int, max_bpv: int = 1,
                     g_in: Optional[SlabGraph] = None
                     ) -> Tuple[TreeState, int]:
    """The inserted batch is the first edge frontier; then converge."""
    state, improved = relax_edges(state, bsrc, bdst, bw, bmask)
    return run_to_convergence(g, state, improved,
                              edge_capacity=edge_capacity, max_bpv=max_bpv,
                              g_in=g_in)


def _invalidate(state: TreeState, bsrc, bdst, bmask) -> TreeState:
    """A deleted tree edge (u, v) invalidates v."""
    n = state.dist.shape[0]
    v = torch.where(bmask, bdst, n).long()
    is_tree = bmask & (state.parent[v.clamp(max=n - 1)] == bsrc)
    tgt = v[is_tree]
    dist, parent = state.dist.clone(), state.parent.clone()
    dist[tgt] = INF
    parent[tgt] = NO_PARENT
    return TreeState(dist, parent)


def _propagate_invalidation(state: TreeState, src: int,
                            n_rounds: int) -> TreeState:
    """v survives iff its parent chain reaches ``src`` through valid
    vertices: pointer doubling, ``n_rounds`` gathers."""
    n = state.dist.shape[0]
    reach = torch.zeros(n, dtype=torch.bool, device=state.dist.device)
    reach[src] = True
    anc = torch.where(state.dist < INF, state.parent, NO_PARENT)
    anc[src] = NO_PARENT
    for _ in range(n_rounds):
        has = anc >= 0
        a = anc.clamp_min(0).long()
        reach = reach | (has & reach[a])
        anc = torch.where(has, anc[a], NO_PARENT)
    return TreeState(torch.where(reach, state.dist, INF),
                     torch.where(reach, state.parent, NO_PARENT))


def _reseed_edges(g: SlabGraph, alive: torch.Tensor):
    """Every pool edge from a surviving vertex into an invalidated one, as an
    edge list (src, dst, weight).  The pool is scanned in row chunks with
    int32/bool temporaries; only the selected edges are materialised."""
    n = g.n_vertices
    view = pool_edges(g)
    srcs, dsts, ws = [], [], []
    for r0 in range(0, g.capacity_slabs, _SCAN_ROWS):
        r1 = min(r0 + _SCAN_ROWS, g.capacity_slabs)
        valid = view.valid[r0:r1]
        keys = view.dst[r0:r1]
        owner_alive = alive[g.slab_vertex[r0:r1].clamp_min(0).long()]
        # a key outside [0, n) reads alive[n - 1], the reference's clamp
        sel = valid & owner_alive[:, None] & \
            ~alive[torch.where(valid, keys, 0).clamp(0, n - 1).long()]
        rows, lanes = torch.nonzero(sel, as_tuple=True)
        srcs.append(g.slab_vertex[r0:r1][rows])
        dsts.append(keys[rows, lanes])
        if g.weights is not None:
            ws.append(g.weights[r0:r1][rows, lanes])
    src = torch.cat(srcs)
    w = torch.cat(ws) if ws else torch.ones(src.shape[0],
                                            dtype=torch.float32,
                                            device=g.device)
    return src, torch.cat(dsts), w


def sssp_decremental(g: SlabGraph, state: TreeState, bsrc, bdst, bmask, *,
                     src: int, edge_capacity: int, max_bpv: int = 1,
                     n_rounds: int = 32, g_in: Optional[SlabGraph] = None
                     ) -> Tuple[TreeState, int]:
    """Invalidate, re-seed from surviving-to-invalidated edges, converge.
    ``g`` already has the batch deleted.

    The reference relaxes the whole pool with a mask; relaxing only the
    selected edges gives the same planes, since masked edges contribute the
    identity, without materialising the pool as an edge list.
    """
    state = _invalidate(state, bsrc, bdst, bmask)
    state = _propagate_invalidation(state, src, n_rounds)
    esrc, edst, ew = _reseed_edges(g, state.dist < INF)
    state, improved = relax_edges(state, esrc, edst, ew,
                                  torch.ones_like(esrc, dtype=torch.bool))
    return run_to_convergence(g, state, improved,
                              edge_capacity=edge_capacity, max_bpv=max_bpv,
                              g_in=g_in)


def tree_state_like(n_vertices: int) -> TreeState:
    """The checkpoint skeleton of a tree state: (float32, int32) planes."""
    return TreeState(torch.zeros(n_vertices, dtype=torch.float32),
                     torch.zeros(n_vertices, dtype=torch.int32))


def stream_property(src: int, *, edge_capacity: int, max_bpv: int = 1,
                    n_rounds: int = 32):
    """PropertySpec: the ⟨distance, parent⟩ SSSP tree from ``src``.  A
    batch's deletes run the decremental invalidate and re-seed path, its
    inserts the incremental relaxation; both converge by sweeping the
    store's transpose view.  Unweighted stores use unit weights."""
    from ..stream.properties import PropertySpec

    def _init(store):
        state, _ = sssp_static(store.forward, src,
                               edge_capacity=edge_capacity, max_bpv=max_bpv,
                               g_in=store.transpose)
        return state

    def _on_batch(store, state, batch):
        if batch.del_src is not None:
            state, _ = sssp_decremental(store.forward, state, batch.del_src,
                                        batch.del_dst, batch.del_mask,
                                        src=src, edge_capacity=edge_capacity,
                                        max_bpv=max_bpv, n_rounds=n_rounds,
                                        g_in=store.transpose)
        if batch.ins_src is not None:
            w = (batch.ins_w if batch.ins_w is not None
                 else torch.ones(batch.ins_src.shape[0], dtype=torch.float32,
                                 device=batch.ins_src.device))
            state, _ = sssp_incremental(store.forward, state, batch.ins_src,
                                        batch.ins_dst, w, batch.ins_mask,
                                        edge_capacity=edge_capacity,
                                        max_bpv=max_bpv, g_in=store.transpose)
        return state

    return PropertySpec(name=f"sssp_{src}", init=_init, on_batch=_on_batch,
                        refresh=_init, state_like=tree_state_like)
