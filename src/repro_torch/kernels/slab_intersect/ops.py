"""The intersection engine of the triangle plane (paper Alg. 9), from
``repro.kernels.slab_intersect.ops``.

``count_edges`` computes Σ_edges |N_G1(u) ∩ N_G2(v)|: per edge (u, v), the
candidates w come from v's adjacency in G2 (bucket enumeration bounded by
``max_bpv``) and are probed for (u, w) in G1 through G1's hash index.  The
work items are the active (edge, bucket) pairs of the reference's dense
layout, in its order (edge-major, buckets ascending), with its inactive
slots left out: the dense layout is ``len(edges) * max_bpv`` slots, nearly
all empty at a skewed graph's bucket counts.

Engines (``impl``):

* ``cuda``   - the ``slab_count`` kernel (CUDA tensors);
* ``torch``  - its plain version, ``slab_count_torch`` (CPU tensors);
* ``oracle`` - ``ref.count_edges_ref``, the whole-batch walk;
* ``auto``   - ``cuda`` or ``torch``, following the tensors.

All are count-identical, since the sum is order-independent.  Totals are
0-d int64 tensors: at the serve's RMAT scale-20 graph Σ|N(u) ∩ N(v)| = 6T
is above 2**31, where the reference's int32 total wraps.

The per-shard forms: ``count_edges_local`` is the uninstrumented body,
``count_shards`` counts every shard of stacked pools in turn.
"""
from __future__ import annotations

import torch

from ...core.device import IMPLS as _DEVICE_IMPLS, resolve_impl
from ...core.hashing import INVALID_SLAB, is_valid_vertex
from ...core.slab_graph import SlabGraph, shard_view
from ...obs.instrument import timed_dispatch
from ..slab_update.ref import edge_buckets, probe
from .kernel import probe_hits, slab_count
from .ref import count_edges_ref, probe_hits_ref, search_edges_ref

IMPLS = _DEVICE_IMPLS + ("oracle",)


def _resolve(impl: str, t: torch.Tensor) -> str:
    return impl if impl == "oracle" else resolve_impl(impl, t)


def _work_items(g2: SlabGraph, us, vs, emask, *, max_bpv: int):
    """The active (edge, bucket) items: per item the head slab of v's
    bucket in G2 and u, both (n,) int32, edge-major with buckets ascending.

    These are the active slots, in order, of the reference's dense layout
    (``edges * max_bpv`` slots, where an edge's slot j is active when the
    edge is masked in and j < bucket_count[v]).  Sizing the list reads its
    length on the host: one sync.
    """
    v = torch.where(emask, vs, 0).long()
    n_b = torch.where(emask, g2.bucket_count[v].clamp(max=max_bpv),
                      0).long()
    edge = torch.repeat_interleave(n_b)
    j = torch.arange(edge.numel(), device=us.device) \
        - (torch.cumsum(n_b, 0) - n_b)[edge]
    start = (g2.bucket_offset[v[edge]] + j).to(torch.int32)
    return start, us[edge].to(torch.int32)


@timed_dispatch("slab_intersect")
def count_edges(g1: SlabGraph, g2: SlabGraph, us: torch.Tensor,
                vs: torch.Tensor, emask: torch.Tensor, *, impl: str = "auto",
                max_bpv: int = 4) -> torch.Tensor:
    """Alg. 9's ``Count(G1, G2, edges)``: Σ_edges |N_G1(u) ∩ N_G2(v)| over
    the masked (us, vs) pairs, a 0-d int64 tensor.

    ``max_bpv`` must bound G2's bucket counts (never G1's: the membership
    probe into G1 is hash-indexed).
    """
    impl = _resolve(impl, g1.keys)
    if impl == "oracle":
        return count_edges_ref(g1, g2, us, vs, emask, max_bpv=max_bpv)
    start, u = _work_items(g2, us, vs, emask, max_bpv=max_bpv)
    per_item = slab_count(g1.keys, g1.next_slab, g1.bucket_offset,
                          g1.bucket_count, g2.keys, g2.next_slab, start, u)
    return per_item.sum(dtype=torch.int64)


#: the body without the instrumentation wrapper
count_edges_local = count_edges.__wrapped__


def count_shards(graphs1: SlabGraph, graphs2: SlabGraph, us: torch.Tensor,
                 vs: torch.Tensor, emask: torch.Tensor, *,
                 impl: str = "auto", max_bpv: int = 4) -> torch.Tensor:
    """Shard-stacked ``count_edges``: a leading shard axis on every
    argument, ``(n_shards,)`` int64 counts out.  ``us``, ``vs`` and
    ``emask`` are ``(n_shards, B)`` per-shard work queues."""
    return torch.stack([
        count_edges_local(shard_view(graphs1, k), shard_view(graphs2, k),
                          us[k], vs[k], emask[k], impl=impl, max_bpv=max_bpv)
        for k in range(graphs1.keys.shape[0])])


def _walk_chains(g: SlabGraph, cur: torch.Tensor, max_chain: int
                 ) -> torch.Tensor:
    """The first ``max_chain`` rows of each chain from ``cur``, -1 padded:
    ``cur.shape + (max_chain,)``."""
    rows = []
    for _ in range(max_chain):
        rows.append(cur)
        cur = torch.where(cur != INVALID_SLAB,
                          g.next_slab[cur.clamp_min(0).long()], INVALID_SLAB)
    return torch.stack(rows, dim=-1)


def adjacency_rows(g: SlabGraph, vs: torch.Tensor, mask: torch.Tensor, *,
                   max_bpv: int = 4, max_chain: int = 8) -> torch.Tensor:
    """Slab rows of v's full adjacency: every bucket's chain, -1 padded.

    Returns (Q, max_bpv * max_chain) int32 pool rows, bucket-major.  Chains
    longer than ``max_chain`` truncate: callers size it from ``pool_stats``'s
    longest chain.
    """
    v = torch.where(mask, vs, 0).long()
    j = torch.arange(max_bpv, dtype=torch.int32, device=vs.device)[None, :]
    bmask = mask[:, None] & (j < g.bucket_count[v][:, None])
    cur = torch.where(bmask, g.bucket_offset[v][:, None] + j,
                      INVALID_SLAB).to(torch.int32)
    return _walk_chains(g, cur, max_chain).reshape(vs.shape[0], -1)


def materialize_chains(g: SlabGraph, us: torch.Tensor, ws: torch.Tensor,
                       mask: torch.Tensor, *, max_chain: int
                       ) -> torch.Tensor:
    """For each (u, w) query, the slab rows of u's bucket chain for w, -1
    padded to (Q, max_chain).  Chains longer than ``max_chain`` truncate."""
    b = edge_buckets(g, us, ws, mask)
    cur = torch.where(mask, b, INVALID_SLAB).to(torch.int32)
    return _walk_chains(g, cur, max_chain)


def search_edges_kernel(g: SlabGraph, us: torch.Tensor, ws: torch.Tensor,
                        mask: torch.Tensor, *, max_chain: int = 8,
                        impl: str = "auto") -> torch.Tensor:
    """Batched (u, w) membership over the host-materialised chains
    (``max_chain`` must reach each chain's end): the ``probe_hits`` kernel
    on CUDA tensors, ``probe_hits_ref`` on CPU tensors (``impl`` as
    ``core.device.resolve_impl`` takes it)."""
    rows = materialize_chains(g, us, ws, mask, max_chain=max_chain)
    if resolve_impl(impl, g.keys) == "torch":
        return probe_hits_ref(ws, rows, g.keys) & mask
    return probe_hits(ws, rows, g.keys) & mask


__all__ = ["IMPLS", "count_edges", "count_edges_local", "count_shards",
           "adjacency_rows", "materialize_chains",
           "search_edges_kernel", "probe_hits_ref", "count_edges_ref",
           "search_edges_ref"]
