"""Weakly connected components (paper §4.4, §6.4): static and incremental.

Static WCC unions every adjacency of the pool.  Incremental WCC runs the
paper's four schemes:

* ``naive``           - re-union over every slab, blind to where the
  updates landed (time grows with |E|);
* ``slab_iterator``   - every adjacency of the vertices whose per-vertex
  update flag is set;
* ``update_iterator`` - only the lanes inserted this epoch (Fig. 12b,
  Table 6);
* ``batch``           - union over the inserted batch itself, the floor;
  the serving loop uses it.

Decremental WCC on GPUs is an open problem (paper §6.4): an epoch that
deletes recomputes from scratch.

Labels are the minimum vertex id of each component, whatever the scheme.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.slab_graph import SlabGraph, next_pow2
from ..core.union_find import compress, init_parents, union_batch
from ..core.worklist import (pool_edges, updated_edges, updated_lane_mask,
                              updated_vertices)
from ..kernels.slab_sweep.ops import sweep_vertices
from ..kernels.slab_sweep.ref import INT32_MAX
from .sssp import _expand_frontier


def _compact_lanes(g: SlabGraph, lane_mask: torch.Tensor,
                   cap: Optional[int] = None):
    """The masked pool lanes as dense ``(cap,)`` edge buffers ``(u, v,
    mask)`` in pool order; lanes past ``cap`` are dropped, as the
    reference's prefix-sum compaction drops them.  ``cap=None`` sizes the
    buffers to the next power of two at or above the masked-lane count, so
    no lane is dropped.

    Only the selected lanes are gathered (a boolean index of the pool), so
    the temporaries grow with the live lanes, not with the pool.
    """
    per_row = lane_mask.sum(dim=1)
    dst = g.keys[lane_mask]
    src = g.slab_vertex.repeat_interleave(per_row, output_size=dst.numel())
    if cap is None:
        cap = next_pow2(dst.numel())
    n = min(dst.numel(), cap)
    u = torch.zeros(cap, dtype=torch.int32, device=g.device)
    v = torch.zeros(cap, dtype=torch.int32, device=g.device)
    u[:n] = src[:n]
    v[:n] = dst[:n]
    return u, v, torch.arange(cap, device=g.device) < n


def _union_pool(parent: torch.Tensor, g: SlabGraph, lane_mask: torch.Tensor,
                *, cap: Optional[int]) -> torch.Tensor:
    u, v, m = _compact_lanes(g, lane_mask, cap)
    return union_batch(parent, u, v, m)


def wcc_static(g: SlabGraph, *, cap: Optional[int] = None) -> torch.Tensor:
    """One union over every adjacency; (V,) int32 labels."""
    parent = init_parents(g.n_vertices, g.device)
    return compress(_union_pool(parent, g, pool_edges(g).valid, cap=cap))


def wcc_incremental_naive(parent: torch.Tensor, g: SlabGraph, *,
                          cap: Optional[int] = None) -> torch.Tensor:
    """Naive scheme: re-union over every slab list (time grows with |E|)."""
    return compress(_union_pool(parent, g, pool_edges(g).valid, cap=cap))


def _union_frontier(parent: torch.Tensor, ef, cap: int) -> torch.Tensor:
    emask = torch.arange(cap, device=parent.device) < ef.size
    return compress(union_batch(parent, torch.where(emask, ef.src, 0),
                                torch.where(emask, ef.dst, 0), emask))


def wcc_incremental_slab_iterator(parent: torch.Tensor, g: SlabGraph, *,
                                  cap: int, max_bpv: int = 4
                                  ) -> torch.Tensor:
    """SlabIterator scheme: every adjacency of the vertices with updates,
    from a walk of their chains.  ``cap`` bounds the edges walked; only the
    first ``max_bpv`` buckets of a vertex are walked, as in the
    reference."""
    ef = _expand_frontier(g, updated_vertices(g), edge_capacity=cap,
                          max_bpv=max_bpv)
    return _union_frontier(parent, ef, cap)


def wcc_incremental_update_iterator(parent: torch.Tensor, g: SlabGraph, *,
                                    cap: int, max_buckets: int = 0
                                    ) -> torch.Tensor:
    """UpdateIterator scheme: only the slabs holding this epoch's inserts,
    from the flagged buckets' chain walk (the paper's best scheme; ``cap``
    about twice the batch).  ``max_buckets`` defaults to ``cap``; edges or
    buckets past the bounds are dropped without a flag, as in the
    reference."""
    ef = updated_edges(g, max_buckets=max_buckets or cap, out_capacity=cap)
    return _union_frontier(parent, ef, cap)


def wcc_incremental_batch(parent: torch.Tensor, bsrc: torch.Tensor,
                          bdst: torch.Tensor,
                          bmask: torch.Tensor) -> torch.Tensor:
    """Union directly over the inserted batch (int32 ids, masked)."""
    u = torch.where(bmask, bsrc, 0).to(torch.int32)
    v = torch.where(bmask, bdst, 0).to(torch.int32)
    return compress(union_batch(parent, u, v, bmask))


# ----------------------------------------------------------------------------
# min-label propagation on the slab-sweep engine
# ----------------------------------------------------------------------------
# Per super-step every vertex takes the minimum label over its neighbours,
# frontier-masked to the labels that changed in the last round, until no
# label changes.  ``g`` must hold the symmetric adjacency.

def wcc_labelprop_sweep(g: SlabGraph, *, max_iters: int = 100000
                        ) -> Tuple[torch.Tensor, int]:
    """Frontier-masked ``min`` sweeps to a fixpoint: (labels, iterations)."""
    labels = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    changed = torch.ones(g.n_vertices, dtype=torch.bool, device=g.device)
    it = 0
    while it < max_iters and bool(changed.any()):
        nbr_min = sweep_vertices(g, labels, semiring="min", frontier=changed)
        new = torch.minimum(labels, nbr_min)
        changed = new < labels
        labels = new
        it += 1
    return labels, it


def wcc_labelprop_ref(g: SlabGraph, *, max_iters: int = 100000
                      ) -> Tuple[torch.Tensor, int]:
    """Plain oracle of ``wcc_labelprop_sweep``: the same propagation as one
    lane-wise segment minimum (no per-row partials)."""
    n = g.n_vertices
    view = pool_edges(g)
    owner = view.src.reshape(-1)
    valid = view.valid.reshape(-1)
    idx = torch.where(valid, view.dst.reshape(-1), 0).long()
    labels = torch.arange(n, dtype=torch.int32, device=g.device)
    changed = torch.ones(n, dtype=torch.bool, device=g.device)
    it = 0
    while it < max_iters and bool(changed.any()):
        m = valid & changed[idx]
        seg = torch.where(m, owner, n).long()
        vals = torch.where(m, labels[idx], INT32_MAX)
        nbr_min = torch.full((n + 1,), INT32_MAX, dtype=torch.int32,
                             device=g.device).scatter_reduce_(
            0, seg, vals, "amin", include_self=True)[:n]
        new = torch.minimum(labels, nbr_min)
        changed = new < labels
        labels = new
        it += 1
    return labels, it


def count_components(labels: torch.Tensor) -> int:
    return int((labels == torch.arange(labels.shape[0],
                                       device=labels.device)).sum())


# ----------------------------------------------------------------------------
# stream registration hook
# ----------------------------------------------------------------------------

def stream_property(*, cap: Optional[int] = None):
    """PropertySpec: per-vertex component labels.  Insert-only epochs
    advance with ``wcc_incremental_batch``; an epoch that deletes recomputes
    from the forward view."""
    from ..stream.properties import PropertySpec

    def _refresh(store):
        return wcc_static(store.forward, cap=cap)

    def _on_batch(store, labels, batch):
        if batch.n_deleted > 0:
            return _refresh(store)
        if batch.ins_src is not None:
            labels = wcc_incremental_batch(labels, batch.ins_src,
                                           batch.ins_dst, batch.ins_mask)
        return labels

    return PropertySpec(name="wcc", init=_refresh, on_batch=_on_batch,
                        refresh=_refresh,
                        state_like=lambda n: torch.zeros(n, dtype=torch.int32))
