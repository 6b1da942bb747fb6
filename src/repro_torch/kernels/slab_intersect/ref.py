"""Plain oracles of the slab_intersect family (``repro.kernels.
slab_intersect.ref``).

``count_edges_ref`` is the reference's whole-batch walk, kept as the
``oracle`` engine of ``ops.count_edges``: every edge's SlabIterator over v's
chain in G2 advances one slab per step until the longest chain ends, and
each step probes the candidate lanes into G1 in ``lane_chunk`` slices.  It
accumulates in int64, where the reference's int32 total wraps past 2**31.

``probe_hits_ref`` is the oracle of the membership probe.
"""
from __future__ import annotations

import torch

from ...core.hashing import INVALID_SLAB, SLAB_WIDTH, is_valid_vertex
from ...core.slab_graph import SlabGraph
from ..slab_update.ref import edge_buckets, probe


def search_edges_ref(g: SlabGraph, us: torch.Tensor, ws: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The paper's ``SearchEdge`` batched: is (u, w) in G?  One hash-probe
    chain walk per masked lane."""
    b = edge_buckets(g, us, ws, mask)
    found, _, _ = probe(g, b, ws, mask)
    return found & mask


def count_edges_ref(g1: SlabGraph, g2: SlabGraph, us: torch.Tensor,
                    vs: torch.Tensor, emask: torch.Tensor, *,
                    max_bpv: int = 4, lane_chunk: int = 32) -> torch.Tensor:
    """Alg. 9: Σ_edges |N_G1(u) ∩ N_G2(v)| (w drawn from G2's adjacency),
    as a 0-d int64 tensor."""
    E = us.shape[0]
    dev = us.device
    v = torch.where(emask, vs, 0).long()
    j = torch.arange(max_bpv, dtype=torch.int32, device=dev)[None, :]
    bmask = emask[:, None] & (j < g2.bucket_count[v][:, None])
    cur = torch.where(bmask, g2.bucket_offset[v][:, None] + j,
                      INVALID_SLAB).reshape(-1)
    u_flat = us[:, None].expand(E, max_bpv).reshape(-1)
    m_flat = bmask.reshape(-1)
    uu = u_flat[:, None].expand(-1, lane_chunk).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((cur != INVALID_SLAB).any()):
        active = cur != INVALID_SLAB
        c = cur.clamp_min(0).long()
        rows = g2.keys[c]
        wvalid = active[:, None] & is_valid_vertex(rows) & m_flat[:, None]
        for c0 in range(0, SLAB_WIDTH, lane_chunk):
            found = search_edges_ref(
                g1, uu, rows[:, c0:c0 + lane_chunk].reshape(-1),
                wvalid[:, c0:c0 + lane_chunk].reshape(-1))
            total += found.sum()
        cur = torch.where(active, g2.next_slab[c], INVALID_SLAB)
    return total


def probe_hits_ref(ws: torch.Tensor, cand_rows: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """(Q,) bool: does any lane of a query's candidate rows (-1 skipped)
    equal its key?"""
    ok = cand_rows >= 0
    slabs = keys[torch.where(ok, cand_rows, 0).long()]      # (Q, C, 128)
    hit = (slabs == ws[:, None, None]) & ok[..., None]
    return hit.flatten(1).any(dim=1)
