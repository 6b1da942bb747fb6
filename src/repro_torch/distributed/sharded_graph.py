"""ShardedSlabGraph: the dynamic graph, vertex-partitioned into shards.

Vertex ``v`` lives on shard ``v % n_shards`` at local id ``v // n_shards``
(modulo striping spreads a power-law graph's degree mass over the shards
far better than contiguous blocks).  Every shard holds its own SlabGraph
over its local vertices: stored src ids are local, stored dst keys global.
The shards' pools are stacked: every tensor field carries a leading shard
axis, and every per-shard operation runs the per-graph engines (the update
engine, the sweep, the compaction, the intersection count) on each shard's
views in turn, so the in-place commits land in the stack.

Two renderings, as the reference's two dispatches, with equal pools leaf
for leaf:

* the one-device rendering (the reference's ``vmap`` dispatch, which runs
  anywhere): every shard stacked on one device, the cross-shard exchanges
  reshapes over the shard axis (``collectives``' stacked forms);
* the multi-process rendering (the reference's ``shard_map`` dispatch):
  ``place_on_mesh`` pins shard ``r`` to rank ``r`` of a ``("shard",)``
  ``DeviceMesh`` (``ranks.init_shard_mesh``), one process a shard, SPMD.
  The rank keeps its shard's pools with a leading shard axis of 1, so the
  per-shard engine loop runs unchanged on it; an update routes the rank's
  contiguous block of the batch and exchanges the buckets all-to-all
  (``route_exchange``), the fixpoints sweep the rank's shard and
  all-gather the global vector a super-step, and every result the
  reference returns as a global array comes back replicated on every
  rank.  ``dispatch="auto"`` picks the rendering from the graph.

Ids stay int32 bit patterns (``INVALID_VERTEX`` is -1): owner and local id
are computed on the unsigned value.

Routing overflow contract: ``route_edges`` buckets are ``cap`` wide and it
returns the number of edges the fullest owner bucket could not place.
The ``*_edges_sharded`` entry points resolve that on the host: ``cap=None``
is the always-safe full batch length; an explicit smaller ``cap`` grows
(power of two) and re-routes until every edge lands.  No edge is dropped.

The fixpoints of the analytics (``pagerank_sharded``, ``wcc_sharded``,
``bfs_sharded``) are host loops that read one device value per iteration
(the L1 change, or whether any label changed): ``FIX_STATS`` counts the
iterations and those reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.hashing import (EMPTY_KEY, INVALID_SLAB, INVALID_VERTEX,
                            as_key_bits)
from ..core.slab_graph import (FIELDS, SlabGraph, empty, from_edges_numpy,
                               next_pow2, shard_view, stack_graphs)
from ..core.worklist import pool_edges
from ..kernels.slab_intersect.ops import count_edges_local
from ..kernels.slab_sweep.ops import sweep_vertices
from ..kernels.slab_update.ops import query_shards, update_shards
from .collectives import (exchange_buckets, gather_interleaved,
                          max_across_shards, or_across_shards, ring_shift,
                          sum_across_shards)
from .ranks import SHARD_AXIS

UNREACHED = 2 ** 30              # as algorithms.bfs.UNREACHED

_MASK32 = 0xFFFFFFFF

#: the analytics' host loops: iterations run and device values read
FIX_STATS: Dict[str, int] = {"iterations": 0, "host_reads": 0}


def reset_fix_stats() -> None:
    for k in FIX_STATS:
        FIX_STATS[k] = 0


@dataclasses.dataclass
class ShardedSlabGraph:
    # every tensor field leads with n_shards, or with 1 (this rank's
    # shard) on a mesh
    graphs: SlabGraph
    n_shards: int
    n_vertices_global: int
    #: the ("shard",) DeviceMesh the pools are placed on, or None for the
    #: stacked one-device rendering
    mesh: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.graphs.keys.device

    @property
    def group(self):
        """The mesh's ``"shard"`` process group (None when stacked)."""
        return None if self.mesh is None else self.mesh.get_group(SHARD_AXIS)

    @property
    def rank(self) -> Optional[int]:
        """The shard this rank holds (None when stacked)."""
        return (None if self.mesh is None
                else self.mesh.get_local_rank(SHARD_AXIS))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_on_mesh(sg: ShardedSlabGraph, mesh) -> ShardedSlabGraph:
    """Pin the stacked pools to a ``("shard",)`` mesh of one rank a shard:
    rank ``r`` keeps shard ``r``'s pools (a leading shard axis of 1) on
    its device and drops the rest.  Every rank calls it with the same
    stacked graph.  The mesh must be 1-D, named ``("shard",)``, with
    exactly one rank per shard (``ValueError`` otherwise, as the
    reference's)."""
    names = tuple(mesh.mesh_dim_names or ())
    if names != (SHARD_AXIS,):
        raise ValueError(f"expected a ('{SHARD_AXIS}',) mesh, got axes "
                         f"{names}")
    if mesh.size() != sg.n_shards:
        raise ValueError(f"mesh has {mesh.size()} ranks for {sg.n_shards} "
                         "shards (need exactly one each)")
    if sg.mesh is not None:
        if sg.mesh is mesh:
            return sg
        raise ValueError("the pools are placed on another mesh already; "
                         "restore the stacked pools and place them again")
    r = mesh.get_local_rank(SHARD_AXIS)
    dev = _mesh_device(mesh)
    graphs = dataclasses.replace(sg.graphs, **{
        f: None if getattr(sg.graphs, f) is None
        else getattr(sg.graphs, f)[r:r + 1].to(dev, copy=True)
        for f in FIELDS})
    return dataclasses.replace(sg, graphs=graphs, mesh=mesh)


def _resolve_dispatch(dispatch: str, mesh=None) -> str:
    """``"vmap"`` (stacked) or ``"shard_map"`` (mesh) for ``dispatch``;
    ``"auto"`` follows the pools."""
    if dispatch not in ("auto", "vmap", "shard_map"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if dispatch == "auto":
        return "vmap" if mesh is None else "shard_map"
    if dispatch == "shard_map" and mesh is None:
        raise ValueError("dispatch='shard_map' needs mesh-placed pools; "
                         "call place_on_mesh(sg, mesh) first")
    if dispatch == "vmap" and mesh is not None:
        raise ValueError("dispatch='vmap' runs the stacked pools, and a "
                         "mesh-placed graph holds one shard a rank; use "
                         "'shard_map' or 'auto'")
    return dispatch


def shard_empty(n_vertices_global: int, n_shards: int, *,
                capacity_slabs_per_shard: int, weighted: bool = False,
                device="cuda") -> ShardedSlabGraph:
    """Empty shards, one bucket per local vertex, on ``device`` (``cuda``
    unless ``device="cpu"``)."""
    n_local = -(-n_vertices_global // n_shards)
    g0 = empty(n_local, np.ones(n_local, np.int32), capacity_slabs_per_shard,
               weighted=weighted, device=device)
    return ShardedSlabGraph(graphs=stack_graphs([g0] * n_shards),
                            n_shards=n_shards,
                            n_vertices_global=n_vertices_global)


def shard_slice(sg: ShardedSlabGraph, k: int) -> SlabGraph:
    """Shard ``k``'s local SlabGraph (views into the stacked pools).  On a
    mesh a rank holds its own shard only; any other ``k`` raises
    ``ValueError``."""
    if sg.mesh is not None:
        if k != sg.rank:
            raise ValueError(f"rank {sg.rank} holds shard {sg.rank} only, "
                             f"not shard {k}")
        return shard_view(sg.graphs, 0)
    return shard_view(sg.graphs, k)


def worst_next_free(sg: ShardedSlabGraph) -> int:
    """The largest ``next_free`` over the shards (over the ranks on a
    mesh, so every rank reads the same bound): one host read."""
    return int(max_across_shards(sg.graphs.next_free.max(), sg.group))


def global_vector(sg: ShardedSlabGraph, x: torch.Tensor) -> torch.Tensor:
    """A per-shard vertex field of ``sg`` (its leading shard axis) as the
    ``(V,)`` global vector, gathered over the ranks on a mesh."""
    if sg.mesh is None:
        return reassemble_global(x, sg.n_vertices_global)
    return gather_interleaved(x[0], sg.n_vertices_global, sg.group)


def _grow_rows(fields: dict, capacity: int) -> dict:
    """Pad one shard's host pools to ``capacity`` rows (stacking needs
    one shape)."""
    grow = capacity - fields["keys"].shape[0]
    if grow <= 0:
        return fields

    def pad(a, fill):
        return np.concatenate(
            [a, np.full((grow,) + a.shape[1:], fill, a.dtype)])

    out = dict(fields)
    out.update(keys=pad(fields["keys"], EMPTY_KEY),
               next_slab=pad(fields["next_slab"], INVALID_SLAB),
               slab_vertex=pad(fields["slab_vertex"], -1),
               free_list=pad(fields["free_list"], INVALID_SLAB),
               slab_new=pad(fields["slab_new"], False))
    if fields["weights"] is not None:
        out["weights"] = pad(fields["weights"], 0.0)
    return out


def shard_from_edges_host(n_vertices_global: int, n_shards: int, src, dst,
                          weights=None, *, slack_slabs: int = 0,
                          device="cuda") -> ShardedSlabGraph:
    """Bulk-build the shards on the host: partition the edges by owner,
    build each shard's dense pool (one bucket per local vertex, local src,
    global dst keys), pad every pool to one power-of-two capacity, stack,
    and move the stack to ``device``.  The same pools as routing the edges
    through ``insert_edges_sharded`` into ``shard_empty``, sized to the
    edges stored."""
    src = np.asarray(src, dtype=np.uint32)
    dst = np.asarray(dst, dtype=np.uint32)
    w = None if weights is None else np.asarray(weights, dtype=np.float32)
    n_local = -(-n_vertices_global // n_shards)
    shards = []
    for k in range(n_shards):
        m = (src % np.uint32(n_shards)) == k
        shards.append(from_edges_numpy(
            n_local, src[m] // np.uint32(n_shards), dst[m],
            None if w is None else w[m], hashing=False,
            slack_slabs=slack_slabs))
    cap = next_pow2(max(f["keys"].shape[0] for f in shards))
    shards = [_grow_rows(f, cap) for f in shards]
    dev = resolve_device(device)
    tensors = {}
    for name in FIELDS:
        if shards[0][name] is None:
            tensors[name] = None
            continue
        a = np.stack([np.asarray(f[name]) for f in shards])
        dtype = (np.float32 if name == "weights" else
                 bool if name in ("upd_flag", "slab_new") else np.int32)
        tensors[name] = torch.from_numpy(
            np.ascontiguousarray(a.astype(dtype, copy=False))).to(dev)
    graphs = SlabGraph(**tensors, n_vertices=n_local,
                       n_buckets=int(shards[0]["bucket_vertex"].size),
                       weighted=w is not None)
    return ShardedSlabGraph(graphs=graphs, n_shards=n_shards,
                            n_vertices_global=n_vertices_global)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as int32 bit patterns."""
    return (((x & _MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def owner_of(v: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard of each id (int32 bit patterns, unsigned value)."""
    return ((v.long() & _MASK32) % n_shards).to(torch.int32)


def local_id(v: torch.Tensor, n_shards: int) -> torch.Tensor:
    return _bits((v.long() & _MASK32) // n_shards)


def global_id(local: torch.Tensor, shard: torch.Tensor,
              n_shards: int) -> torch.Tensor:
    return _bits((local.long() & _MASK32) * n_shards
                 + (shard.long() & _MASK32))


def reassemble_global(x_local: torch.Tensor, n_vertices_global: int
                      ) -> torch.Tensor:
    """``(n_shards, n_local)`` per-shard vector to the ``(V,)`` global one
    (``collectives.gather_interleaved``)."""
    return gather_interleaved(x_local, n_vertices_global)


def ensure_capacity_sharded(sg: ShardedSlabGraph, extra_slabs: int, *,
                            high: Optional[int] = None) -> ShardedSlabGraph:
    """Grow the stacked pools (axis 1, the slab rows) so that every shard
    has at least ``extra_slabs`` free slabs; capacities walk the power-of-
    two ladder of the unsharded ``ensure_capacity``.

    ``high`` is a host bound on the worst shard's allocated rows; without
    it the device is read once (the headroom ``next_free - free_top``,
    crediting recyclable slabs; the worst over the ranks on a mesh, so
    every rank grows to one row count).  Growth happens here, on the
    stacked tensors, never inside a per-shard engine call: the engine
    writes through views of the stack."""
    g = sg.graphs
    cap = g.keys.shape[1]
    if high is None:
        high = int(max_across_shards((g.next_free - g.free_top).max(),
                                     sg.group))
    if cap - high >= extra_slabs:
        return sg
    target = max(high + extra_slabs, cap + cap // 2)
    grow = next_pow2(target) - cap

    def pad_rows(a, fill):
        pad = torch.full((a.shape[0], grow) + tuple(a.shape[2:]), fill,
                         dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], dim=1)

    graphs = dataclasses.replace(
        g,
        keys=pad_rows(g.keys, EMPTY_KEY),
        weights=None if g.weights is None else pad_rows(g.weights, 0.0),
        next_slab=pad_rows(g.next_slab, INVALID_SLAB),
        slab_vertex=pad_rows(g.slab_vertex, -1),
        free_list=pad_rows(g.free_list, INVALID_SLAB),
        slab_new=pad_rows(g.slab_new, False),
    )
    return dataclasses.replace(sg, graphs=graphs)


# ----------------------------------------------------------------------------
# owner routing: the one global exchange of an update
# ----------------------------------------------------------------------------

def _scatter_into(n: int, fill, dtype, slot, vals, device) -> torch.Tensor:
    """``(n,)`` tensor of ``fill`` with ``vals`` at ``slot``; slots past
    the end are dropped."""
    out = torch.full((n + 1,), fill, dtype=dtype, device=device)
    out[slot] = vals.to(dtype)
    return out[:n]


def _route_body(src, dst, w, *, n_shards: int, cap: int):
    """Owner routing: (B,) global edges to ``(n_shards, cap)`` per-owner
    buckets.  A stable sort by owner with invalid lanes last, then each
    edge's rank within its owner's run is its slot: the reference's order,
    slot for slot."""
    dev = src.device
    B = src.shape[0]
    valid = src != INVALID_VERTEX
    u = src.long() & _MASK32
    own = torch.where(valid, u % n_shards, n_shards)
    order = torch.sort(own, stable=True).indices
    so, ss, sd = own[order], u[order], dst[order]
    idx = torch.arange(B, device=dev)
    run_start = torch.ones(B, dtype=torch.bool, device=dev)
    if B > 1:
        run_start[1:] = so[1:] != so[:-1]
    base = torch.cummax(torch.where(run_start, idx, -1), 0).values \
        if B else idx
    rank = idx - base
    # the true longest owner run: the overflow witness
    max_run = (torch.where(so < n_shards, rank + 1, 0).max() if B
               else torch.zeros((), dtype=torch.int64, device=dev))
    overflow = (max_run - cap).clamp_min(0)
    ok = (so < n_shards) & (rank < cap)
    n = n_shards * cap
    slot = torch.where(ok, so * cap + rank, n)
    bsrc = _scatter_into(n, INVALID_VERTEX, torch.int32, slot,
                         _bits(ss // n_shards), dev)
    bdst = _scatter_into(n, INVALID_VERTEX, torch.int32, slot, sd, dev)
    origin = _scatter_into(n, -1, torch.int32, slot, order, dev)
    bw = None
    if w is not None:
        bw = _scatter_into(n, 0.0, torch.float32, slot, w[order],
                           dev).reshape(n_shards, cap)
    return (bsrc.reshape(n_shards, cap), bdst.reshape(n_shards, cap), bw,
            origin.reshape(n_shards, cap), overflow)


def route_edges(src: torch.Tensor, dst: torch.Tensor,
                w: Optional[torch.Tensor] = None, *, n_shards: int,
                cap: int):
    """Owner routing: (B,) global edges to ``(n_shards, cap)`` per-owner
    buckets (src localised, INVALID padding, weights alongside).

    Returns ``(bsrc, bdst, bw, origin, overflow)``: ``origin`` maps bucket
    slots back to batch positions (-1 pad), ``bw`` is None when ``w`` is,
    ``overflow`` (0-d) is how many edges the fullest owner bucket lacked
    room for.  ``overflow > 0`` means the buckets miss edges: grow ``cap``
    and route again (the ``*_edges_sharded`` entry points do)."""
    return _route_body(src, dst, w, n_shards=n_shards, cap=cap)


def route_exchange(src: torch.Tensor, dst: torch.Tensor,
                   w: Optional[torch.Tensor], *, n_shards: int, cap: int,
                   mesh):
    """Owner routing on a mesh: this rank's ``(B_l,)`` contiguous block of
    the batch (block ``r`` of rank ``r``) routed into ``(n_shards, cap)``
    per-owner buckets (``_route_body``'s plan at 1/S the size), then the
    buckets exchanged all-to-all, so row ``i`` holds what rank ``i``
    routed here.

    Returns ``(bsrc, bdst, bw, origin, overflow)`` flattened to
    ``(n_shards * cap,)``: this rank's edges in global batch order with
    INVALID padding at each source segment's tail (interior padding,
    where the stacked routing pads only the tail: the update engine sorts
    pads last, so its pools do not depend on where they sit).  ``origin``
    holds global batch positions; ``overflow`` is the largest witness over
    the ranks, the same on every rank.  One all-to-all carries src, dst,
    origin and the weights' bits together."""
    me = mesh.get_local_rank(SHARD_AXIS)
    group = mesh.get_group(SHARD_AXIS)
    n_local = src.shape[0]
    bsrc, bdst, bw, origin, over = _route_body(src, dst, w,
                                               n_shards=n_shards, cap=cap)
    origin = torch.where(origin >= 0, origin + me * n_local, -1)
    cols = [bsrc, bdst, origin]
    if bw is not None:
        cols.append(bw.view(torch.int32))
    got = exchange_buckets(torch.stack(cols, dim=-1), group)
    flat = got.reshape(-1, len(cols))
    bw = None if bw is None else flat[:, 3].contiguous().view(torch.float32)
    return (flat[:, 0].contiguous(), flat[:, 1].contiguous(), bw,
            flat[:, 2].contiguous(), max_across_shards(over, group))


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= n, with a floor of 1."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _host_ids(a) -> np.ndarray:
    """Host uint64 id values of uint32 ids or int32 bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return as_key_bits(np.asarray(a)).view(np.uint32).astype(np.uint64)


def max_owner_count(src, n_shards: int) -> int:
    """Exact largest per-owner edge count of a batch (host): sizes the
    routing buckets and bounds the worst shard's new slabs (one per
    edge) in the store's host accounting."""
    src = _host_ids(src)
    src = src[src != np.uint64(_MASK32)]
    if src.size == 0:
        return 0
    return int(np.bincount((src % n_shards).astype(np.int64),
                           minlength=n_shards).max())


def routing_cap(src, n_shards: int) -> int:
    """Exact bucket sizing (host): the power of two at or above the
    largest per-owner edge count."""
    return _pow2ceil(max_owner_count(src, n_shards))


def routing_cap_blocks(src, n_shards: int, block: int) -> int:
    """Bucket sizing when each source shard routes one contiguous
    ``block`` of the batch: the power of two at or above the largest
    (source block, owner) pair count.  (The multi-process rendering's
    sizing; the one-device rendering routes the whole batch at once.)"""
    src = _host_ids(src)
    valid = src != np.uint64(_MASK32)
    if valid.size == 0 or block <= 0:
        return 1
    blk = np.arange(src.size) // block
    own = (src % n_shards).astype(np.int64)
    pair = blk * n_shards + own
    counts = np.bincount(pair[valid],
                         minlength=int(blk[-1] + 1) * n_shards)
    return _pow2ceil(int(counts.max(initial=0)))


def _shard_blocks(sg: ShardedSlabGraph, src, dst, w):
    """A mesh rank's contiguous block of a ``(B,)`` batch that every rank
    holds, padded with INVALID to a multiple of the shard count."""
    S, me = sg.n_shards, sg.rank
    p = -(-src.shape[0] // S) * S
    if p != src.shape[0]:
        pad = p - src.shape[0]

        def padded(x, fill):
            return torch.cat([x, x.new_full((pad,), fill)])

        src, dst = padded(src, INVALID_VERTEX), padded(dst, INVALID_VERTEX)
        w = None if w is None else padded(w, 0.0)
    n = p // S
    blk = slice(me * n, (me + 1) * n)
    return src[blk], dst[blk], None if w is None else w[blk]


def _resolve_routing(sg: ShardedSlabGraph, src, dst, w, cap: Optional[int]):
    """Route with a cap that places every edge; buckets ``(n_shards,
    cap)`` stacked, ``(1, n_shards * cap)`` on a mesh (this rank's engine
    batch, ``route_exchange``).

    ``cap=None`` (only None: ``cap=0`` is an explicit, growable size) is
    the routed length (the batch, or a mesh rank's block of it), which no
    owner bucket can exceed.  A smaller cap is checked against the
    overflow witness on the host (one read; the same on every rank) and
    grown (power of two) until every edge lands; a retry budget turns an
    overflow storm (a fault plan's ``route.resolve`` site) into
    ``RetryExhausted`` instead of a spin."""
    if sg.mesh is not None:
        src, dst, w = _shard_blocks(sg, src, dst, w)
    n = src.shape[0]
    if cap is None:
        cap = n
    attempts = 0
    max_attempts = max(4, n.bit_length() + 2)
    while True:
        if sg.mesh is None:
            bsrc, bdst, bw, origin, overflow = route_edges(
                src, dst, w, n_shards=sg.n_shards, cap=cap)
        else:
            bsrc, bdst, bw, origin, overflow = route_exchange(
                src, dst, w, n_shards=sg.n_shards, cap=cap, mesh=sg.mesh)
            bsrc, bdst = bsrc[None], bdst[None]
            bw = None if bw is None else bw[None]
        if cap >= n:          # no bucket can overflow: no host read
            return bsrc, bdst, bw, origin
        from ..resilience import faults
        over = int(overflow) + faults.fault_overflow(
            "route.resolve", cap=cap, n=n)
        if over == 0:
            return bsrc, bdst, bw, origin
        attempts += 1
        if attempts >= max_attempts:
            from ..resilience.guard import RetryExhausted
            raise RetryExhausted(
                "route.resolve", attempts,
                RuntimeError(f"routing still overflows at cap {cap} "
                             f"(batch {n}, overflow {over})"))
        new_cap = min(next_pow2(cap + over, lo=1), n)
        from .. import obs
        obs.instant("route.grow_retry", cap=cap, over=over,
                    new_cap=new_cap)
        obs.emit_event("route_grow_retry", cap=cap, overflow=over,
                       new_cap=new_cap)
        obs.inc("route.grow_retry")
        cap = new_cap


def _scatter_back(mask: torch.Tensor, origin: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``(n_shards, cap)`` per-slot results to ``(B,)`` batch-aligned."""
    at = torch.where(origin >= 0, origin, n).reshape(-1).long()
    out = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    out[at] = mask.reshape(-1)
    return out[:n]


def _batch_mask(sg: ShardedSlabGraph, mask: torch.Tensor,
                origin: torch.Tensor, n: int) -> torch.Tensor:
    """Per-slot engine results to the ``(n,)`` mask over the caller's
    batch; on a mesh each rank holds the slots it owns, so the partial
    masks are ORed over the ranks (the same mask on every rank)."""
    if sg.mesh is None:
        return _scatter_back(mask, origin, n)
    p = -(-n // sg.n_shards) * sg.n_shards
    return or_across_shards(_scatter_back(mask, origin, p), sg.group)[:n]


# ----------------------------------------------------------------------------
# batched mutation through the update engine
# ----------------------------------------------------------------------------

def _empty_mask(sg: ShardedSlabGraph) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.bool, device=sg.device)


def insert_edges_sharded(sg: ShardedSlabGraph, src: torch.Tensor,
                         dst: torch.Tensor, w: Optional[torch.Tensor] = None,
                         *, cap: Optional[int] = None
                         ) -> Tuple[ShardedSlabGraph, torch.Tensor]:
    """Batched insert across shards: owner routing, then one
    ``update_shards``.  ``cap`` bounds the per-shard batch (None: the
    whole batch, always safe; a smaller cap grows on overflow).  Consumes
    ``sg`` (in-place commit); returns the inserted mask over the batch.
    On a mesh every rank passes the same batch and gets the same mask,
    and ``cap`` bounds a (source rank, owner) bucket."""
    if src.shape[0] == 0:
        return sg, _empty_mask(sg)
    bsrc, bdst, bw, origin = _resolve_routing(sg, src, dst, w, cap)
    graphs, ins, _ = update_shards(sg.graphs, ins=(bsrc, bdst, bw))
    return (dataclasses.replace(sg, graphs=graphs),
            _batch_mask(sg, ins, origin, src.shape[0]))


def delete_edges_sharded(sg: ShardedSlabGraph, src: torch.Tensor,
                         dst: torch.Tensor, *, cap: Optional[int] = None
                         ) -> Tuple[ShardedSlabGraph, torch.Tensor]:
    if src.shape[0] == 0:
        return sg, _empty_mask(sg)
    bsrc, bdst, _, origin = _resolve_routing(sg, src, dst, None, cap)
    graphs, _, dele = update_shards(sg.graphs, dels=(bsrc, bdst))
    return (dataclasses.replace(sg, graphs=graphs),
            _batch_mask(sg, dele, origin, src.shape[0]))


def query_edges_sharded(sg: ShardedSlabGraph, src: torch.Tensor,
                        dst: torch.Tensor, *, cap: Optional[int] = None
                        ) -> torch.Tensor:
    if src.shape[0] == 0:
        return _empty_mask(sg)
    bsrc, bdst, _, origin = _resolve_routing(sg, src, dst, None, cap)
    found = query_shards(sg.graphs, bsrc, bdst)
    return _batch_mask(sg, found, origin, src.shape[0])


def apply_update_sharded(sg: ShardedSlabGraph, ins_src=None, ins_dst=None,
                         ins_w=None, del_src=None, del_dst=None, *,
                         cap: Optional[int] = None):
    """One mixed epoch, deletes before inserts: both halves are routed,
    then one ``update_shards`` applies them.  Returns ``(sg, inserted_mask
    | None, deleted_mask | None)``; consumes ``sg``."""
    ins = dels = None
    ins_origin = del_origin = None
    if del_src is not None and del_src.shape[0] > 0:
        ds, dd, _, del_origin = _resolve_routing(sg, del_src, del_dst,
                                                 None, cap)
        dels = (ds, dd)
    if ins_src is not None and ins_src.shape[0] > 0:
        is_, id_, iw, ins_origin = _resolve_routing(sg, ins_src, ins_dst,
                                                    ins_w, cap)
        ins = (is_, id_, iw)
    if ins is None and dels is None:
        return sg, None, None
    graphs, ins_m, del_m = update_shards(sg.graphs, ins=ins, dels=dels)
    sg = dataclasses.replace(sg, graphs=graphs)
    ins_mask = (None if ins_m is None
                else _batch_mask(sg, ins_m, ins_origin, ins_src.shape[0]))
    del_mask = (None if del_m is None
                else _batch_mask(sg, del_m, del_origin, del_src.shape[0]))
    return sg, ins_mask, del_mask


# ----------------------------------------------------------------------------
# analytics on the slab-sweep engine
# ----------------------------------------------------------------------------
#
# Each algorithm is a fixpoint over global super-steps: every shard sweeps
# its pool (``n_keys=V``: the keys are global ids), and the exchange lifts
# the stacked (n_shards, n_local) results to the (V,) global vector.
# ``rows`` bounds every sweep to the allocated pool prefix (the store gives
# it from host accounting).

def _host_read(x: torch.Tensor) -> bool:
    """One device value read on the host by a fixpoint (counted)."""
    FIX_STATS["host_reads"] += 1
    return bool(x)


def _local_slice_idx(V: int, n_shards: int, me: int,
                     device) -> torch.Tensor:
    """Global ids owned by shard ``me``, strided; the tail clamps to V - 1
    (those positions land past V after reassembly and are trimmed)."""
    n_local = -(-V // n_shards)
    return (torch.arange(n_local, device=device) * n_shards + me
            ).clamp_max(V - 1)


def _run_sharded_fix(sg: ShardedSlabGraph, dispatch: str,
                     rows: Optional[int], fix_of: Callable, impl: str):
    """Run one analytics fixpoint, each shard's sweep through
    ``sweep_vertices(impl=impl)``.  ``fix_of(sweep, exchange,
    slice_local)`` returns ``(result (V,), iterations)``: ``sweep(values,
    frontier, semiring)`` is the per-shard sweep, stacked
    ``(n_shards, n_local)``; ``exchange`` lifts that to ``(V,)``;
    ``slice_local`` takes a ``(V,)`` vector's owned slices, stacked.

    On a mesh (``shard_map``) the sweep is this rank's shard alone,
    ``(n_local,)``, the exchange an all-gather over the ranks and
    ``slice_local`` the rank's strided slice: every rank holds the same
    global vectors, so the loop's host reads, and with them the iteration
    counts, agree on every rank, and each returns the full result."""
    mode = _resolve_dispatch(dispatch, sg.mesh)
    V, S = sg.n_vertices_global, sg.n_shards
    if mode == "shard_map":
        g, group = shard_view(sg.graphs, 0), sg.group
        idx = _local_slice_idx(V, S, sg.rank, sg.device)

        def sweep_local(values, frontier, semiring):
            return sweep_vertices(g, values, semiring=semiring,
                                  frontier=frontier, n_keys=V, impl=impl,
                                  rows=rows)

        return fix_of(sweep_local,
                      lambda x: gather_interleaved(x, V, group),
                      lambda x_glob: x_glob[idx])
    idx_all = torch.stack([_local_slice_idx(V, S, s, sg.device)
                           for s in range(S)])

    def exchange(x_stacked):
        return reassemble_global(x_stacked, V)

    def slice_local(x_glob):
        return x_glob[idx_all]

    def sweep(values, frontier, semiring):
        return torch.stack([
            sweep_vertices(shard_view(sg.graphs, k), values,
                           semiring=semiring, frontier=frontier, n_keys=V,
                           impl=impl, rows=rows)
            for k in range(S)])

    return fix_of(sweep, exchange, slice_local)


def _pagerank_fix(sums_local_of, V, pr0, out_degree, damping, error_margin,
                  max_iter, slice_local, exchange):
    """The PageRank fixpoint with per-shard (owned slice) vector math; only
    the global reductions (teleport mass, L1 change) read the exchanged
    (V,) vectors.  One host read (the L1 change) per iteration."""
    zero_out = out_degree == 0
    has_sink = zero_out.any()
    deg_loc = slice_local(out_degree)
    base = (1.0 - damping) / V
    pr = pr0
    it = 0
    delta = torch.tensor(float("inf"), device=pr0.device)
    while it < max_iter and _host_read(delta > error_margin):
        pr_loc = slice_local(pr)
        contrib = exchange(torch.where(deg_loc > 0,
                                       pr_loc / deg_loc.clamp_min(1), 0.0))
        new_loc = base + damping * sums_local_of(contrib)
        teleport = torch.where(zero_out, pr, 0.0).sum() / V
        new_loc = torch.where(has_sink, new_loc + damping * teleport,
                              new_loc)
        new_pr = exchange(new_loc)
        delta = (new_pr - pr).abs().sum()
        pr = new_pr
        it += 1
        FIX_STATS["iterations"] += 1
    return pr, it


def _minfix(min_of, x0, changed0, max_iters):
    """Frontier-masked monotone-min fixpoint (WCC labels, BFS levels); one
    host read (any change) per iteration."""
    x, changed, it = x0, changed0, 0
    while it < max_iters and _host_read(changed.any()):
        new = torch.minimum(x, min_of(x, changed))
        changed = new < x
        x = new
        it += 1
        FIX_STATS["iterations"] += 1
    return x, it


def pagerank_sharded(sg_in: ShardedSlabGraph, out_degree: torch.Tensor, *,
                     init_pr: Optional[torch.Tensor] = None,
                     damping: float = 0.85, error_margin: float = 1e-5,
                     max_iter: int = 100, impl: str = "auto",
                     rows: Optional[int] = None, dispatch: str = "auto"
                     ) -> Tuple[torch.Tensor, int]:
    """PageRank over the in-edge sharded graph; ``(vector, iterations)``.

    Per super-step each shard runs one ``sum`` sweep over its pool; the
    exchange is the reassembly of the (V,) contribution vector.
    ``out_degree`` is the global out-degree vector."""
    V = sg_in.n_vertices_global
    pr0 = (torch.full((V,), 1.0 / V, dtype=torch.float32,
                      device=sg_in.device) if init_pr is None
           else init_pr.to(torch.float32))

    def fix_of(sweep, exchange, slice_local):
        return _pagerank_fix(lambda c: sweep(c, None, "sum"), V, pr0,
                             out_degree, damping, error_margin, max_iter,
                             slice_local, exchange)

    return _run_sharded_fix(sg_in, dispatch, rows, fix_of, impl)


def wcc_sharded(sg_sym: ShardedSlabGraph, *,
                init_labels: Optional[torch.Tensor] = None,
                max_iters: int = 100000, impl: str = "auto",
                rows: Optional[int] = None, dispatch: str = "auto"
                ) -> Tuple[torch.Tensor, int]:
    """WCC by frontier-masked min-label sweeps over the symmetric sharded
    view; labels (the minimum id of each component) are bit-identical to
    ``wcc_labelprop_sweep`` on the unsharded union.  ``init_labels`` warm
    starts an insert-only epoch (labels only decrease)."""
    V = sg_sym.n_vertices_global
    dev = sg_sym.device
    labels0 = (torch.arange(V, dtype=torch.int32, device=dev)
               if init_labels is None else init_labels.to(torch.int32))

    def fix_of(sweep, exchange, _slice):
        return _minfix(lambda x, ch: exchange(sweep(x, ch, "min")),
                       labels0, torch.ones(V, dtype=torch.bool, device=dev),
                       max_iters)

    return _run_sharded_fix(sg_sym, dispatch, rows, fix_of, impl)


def bfs_sharded(sg_in: ShardedSlabGraph, *, src: int,
                init_dist: Optional[torch.Tensor] = None,
                max_iters: int = 100000, impl: str = "auto",
                rows: Optional[int] = None, dispatch: str = "auto"
                ) -> Tuple[torch.Tensor, int]:
    """Level-synchronous BFS over the in-edge sharded graph: one unit
    ``min_plus`` sweep a super-step, masked to the changed frontier.
    Integer levels (UNREACHED = 2**30), bit-identical to ``bfs_vanilla``
    on the unsharded union.  ``init_dist`` warm starts an insert-only
    epoch."""
    V = sg_in.n_vertices_global
    dev = sg_in.device
    if init_dist is None:
        dist0 = torch.full((V,), UNREACHED, dtype=torch.int32, device=dev)
        dist0[src] = 0
        changed0 = torch.zeros(V, dtype=torch.bool, device=dev)
        changed0[src] = True
    else:
        dist0 = init_dist.to(torch.int32).clone()
        dist0[src] = 0
        changed0 = dist0 < UNREACHED

    def fix_of(sweep, exchange, _slice):
        return _minfix(lambda x, ch: exchange(sweep(x, ch, "min_plus")),
                       dist0, changed0, max_iters)

    return _run_sharded_fix(sg_in, dispatch, rows, fix_of, impl)


# ----------------------------------------------------------------------------
# triangle counting (slab_intersect, Alg. 9)
# ----------------------------------------------------------------------------
# 6T = sum_k sum_j Count(shard_j, shard_k, {(u, v) on shard k: owner(u) = j}):
# the candidates N(v) come from shard k = owner(v) (stored src ids are
# local, dst keys global, which is what the count's G2 walk reads), and the
# (u, w) probe resolves on shard j = owner(u), which holds u's adjacency.

def _shard_edges(g: SlabGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local src, global dst) int32 of every live lane of one shard."""
    view = pool_edges(g)
    return (view.src[view.valid].to(torch.int32).contiguous(),
            view.dst[view.valid].contiguous())


def triangle_counts_sharded(graphs: SlabGraph, *, impl: str = "auto",
                            max_bpv: int = 1) -> torch.Tensor:
    """``(n_shards,)`` int64: shard ``k``'s share of 6T, counted over its
    edges with each owner shard ``j`` as G1."""
    S = graphs.keys.shape[0]
    totals = []
    for k in range(S):
        g2 = shard_view(graphs, k)
        es, ed = _shard_edges(g2)
        owner = owner_of(ed, S)
        u_local = local_id(ed, S)
        total = torch.zeros((), dtype=torch.int64, device=graphs.keys.device)
        for r in range(S):
            j = (k + r) % S
            m = owner == j
            total = total + count_edges_local(
                shard_view(graphs, j), g2, u_local, es, m, impl=impl,
                max_bpv=max_bpv)
        totals.append(total)
    return torch.stack(totals)


def _triangle_share_mesh(sg: ShardedSlabGraph, *, impl: str,
                         max_bpv: int) -> torch.Tensor:
    """This rank's share of 6T on a mesh: its shard ``k`` is G2, and G1
    walks the ring, shard ``(k + r) % S`` at rotation ``r`` (the fields
    kernel 7 reads of it passed one rank on a rotation, as the
    reference's S rotations of the stacked G1)."""
    S, k = sg.n_shards, sg.rank
    g2 = shard_view(sg.graphs, 0)
    es, ed = _shard_edges(g2)
    owner = owner_of(ed, S)
    u_local = local_id(ed, S)
    g1 = (g2.keys, g2.next_slab, g2.bucket_offset, g2.bucket_count)
    total = torch.zeros((), dtype=torch.int64, device=sg.device)
    for r in range(S):
        if r:
            g1 = tuple(ring_shift(g1, sg.group))
        g1_graph = dataclasses.replace(
            g2, keys=g1[0], next_slab=g1[1], bucket_offset=g1[2],
            bucket_count=g1[3])
        total = total + count_edges_local(
            g1_graph, g2, u_local, es, owner == (k + r) % S, impl=impl,
            max_bpv=max_bpv)
    return total


def triangles_sharded(sg_sym: ShardedSlabGraph, *, impl: str = "auto",
                      max_bpv: Optional[int] = None,
                      cap: Optional[int] = None) -> torch.Tensor:
    """Global triangle count over the symmetric sharded view, a 0-d int64
    tensor (the sum of 6T fits where the reference's int32 sum wraps).
    Equal to ``algorithms.triangles_static`` on the unsharded union.
    ``max_bpv`` defaults to the power of two at or above the largest
    bucket count over the shards.  On a mesh each rank counts its shard's
    share and the shares are summed in int64 over the ranks (the same
    count on every rank).  The per-shard edge buffers are sized from the
    data; ``cap``, the reference's bound on a shard's compacted edge set,
    is checked against the worst shard's live lanes and raises under it
    (the count never truncates)."""
    graphs = sg_sym.graphs
    if cap is not None:
        live = torch.stack([pool_edges(shard_view(graphs, k)).valid.sum()
                            for k in range(graphs.keys.shape[0])]).max()
        live = int(max_across_shards(live, sg_sym.group))
        if cap < live:
            raise ValueError(f"cap={cap} is under the worst shard's {live} "
                             "live lanes: the count would truncate")
    if max_bpv is None:
        max_bpv = next_pow2(int(max_across_shards(graphs.bucket_count.max(),
                                                  sg_sym.group)), lo=1)
    if sg_sym.mesh is None:
        return triangle_counts_sharded(graphs, impl=impl,
                                       max_bpv=max_bpv).sum() // 6
    share = _triangle_share_mesh(sg_sym, impl=impl, max_bpv=max_bpv)
    return sum_across_shards(share, sg_sym.group) // 6


__all__ = [
    "UNREACHED", "FIX_STATS", "reset_fix_stats", "SHARD_AXIS",
    "ShardedSlabGraph", "place_on_mesh", "shard_empty", "shard_slice",
    "shard_from_edges_host", "owner_of", "local_id", "global_id",
    "reassemble_global", "global_vector", "worst_next_free",
    "ensure_capacity_sharded", "route_edges", "route_exchange",
    "routing_cap", "max_owner_count", "routing_cap_blocks",
    "insert_edges_sharded", "delete_edges_sharded", "query_edges_sharded",
    "apply_update_sharded", "pagerank_sharded", "wcc_sharded",
    "bfs_sharded", "triangle_counts_sharded", "triangles_sharded",
]
