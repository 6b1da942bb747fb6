"""ShardedGraphStore: the versioned multi-view update plane, vertex-
partitioned into shards: stacked on one device, or one shard a process.

The sharded rendering of ``GraphStore``: the forward, transpose and
symmetric views are each a ``ShardedSlabGraph`` (stacked shard-local
pools, modulo vertex striping), kept consistent as one versioned unit.
Per ``apply(inserts, deletes)`` the contract is the unsharded store's,
plus the distribution rules:

  1. one host canonicalisation (``canonical_batch``, shared with the
     unsharded store), then per-view owner routing: the forward view
     routes by ``owner(src)``, the transpose by ``owner(dst)``, the
     symmetric union by each direction's own source;
  2. routing buckets are sized on the host from the true largest
     per-owner count, on sticky rungs (``_cap_rung``: caps only ratchet
     up, and reset at maintenance), so a skewed batch that lands on one
     shard still routes every edge;
  3. deletes before inserts; the symmetric union asks the post-delete
     forward view whether the reverse direction survives;
  4. every shard's pools mutate through the update engine (the probe and
     commit kernels on the card), shard by shard on views of the stacked
     pools; growth happens on the stacked pools before the engine runs
     (``ensure_capacity_sharded``), so the engine never reallocates a
     pool it writes through.  Two renderings with equal pools leaf for
     leaf, as the reference's two dispatches: the stacked one
     (``vmap``), and the multi-process one (``shard_map``, after
     ``place_on_mesh``): each rank routes its contiguous block of the
     batch, exchanges the buckets all-to-all (``route_exchange``) and
     mutates its own shard (``_apply_epoch_mesh``);
  5. the epoch closes with ``update_slab_pointers`` on the stacked pools;
     the version, the bounded batch log and the listeners are
     ``GraphStore``'s, so ``PropertyRegistry`` and ``RequestPipeline``
     work unchanged;
  6. capacity headroom and the analytics' sweep bounds come from host
     accounting (``_high``, ``sweep_rows``): steady epochs never read the
     device for them.  On a mesh every host decision (caps, growth,
     maintenance, fixpoint lengths) is taken from values that are equal
     on every rank (the canonical batch every rank holds, maxima and sums
     over the ranks), so the ranks' collectives never diverge.

The whole fused epoch records as one ``slab_update.update_shards``
dispatch in the kernel statistics (``obs.instrument``), one a rank on a
mesh.  The sharded ``stream_property`` hooks (PageRank, WCC, BFS,
triangles) live here too, and on a mesh return the same result on every
rank.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..core.device import resolve_device
from ..core.hashing import INVALID_VERTEX, SLAB_WIDTH
from ..core.slab_graph import (FIELDS, SlabGraph, next_pow2, pool_stats,
                               update_slab_pointers)
from ..core.worklist import EdgeFrontier, expand_vertices
from ..distributed.collectives import (gather_objects, gather_stacked,
                                      max_across_shards, or_across_shards,
                                      sum_across_shards)
from ..distributed.sharded_graph import (ShardedSlabGraph, _resolve_dispatch,
                                         _route_body, _scatter_back,
                                         bfs_sharded, ensure_capacity_sharded,
                                         global_vector, max_owner_count,
                                         pagerank_sharded, place_on_mesh,
                                         route_exchange, routing_cap,
                                         routing_cap_blocks,
                                         shard_from_edges_host, shard_slice,
                                         triangles_sharded, wcc_sharded,
                                         worst_next_free)
from ..kernels.slab_compact import compact_shards, reclaim_shards
from ..kernels.slab_update.ops import query_shards, update_shards
from ..obs.instrument import timed_dispatch
from ..resilience import faults
from ..resilience.guard import run_with_retries, validate_batch
from .store import (ALL_VIEWS, FORWARD, SYMMETRIC, TRANSPOSE, AppliedBatch,
                    VersionedStoreBase, _FL_ADMIT, _FL_CLOSE, _FL_DISPATCH,
                    _FL_GROW, _FL_POST_WAL, _flight, _pad_f32, _pad_ids,
                    canonical_batch, dedup_pairs)


# ----------------------------------------------------------------------------
# the fused multi-view epoch: route and mutate every view
# ----------------------------------------------------------------------------

def _route_update(sg: ShardedSlabGraph, s, d, w, cap, *, dels: bool):
    """Route one half-batch and run it through ``update_shards``; returns
    ``(sg, mask (n_shards, cap), origin)``."""
    bs, bd, bw, origin, _ = _route_body(s, d, w, n_shards=sg.n_shards,
                                        cap=cap)
    if dels:
        graphs, _, m = update_shards(sg.graphs, dels=(bs, bd))
    else:
        graphs, m, _ = update_shards(sg.graphs, ins=(bs, bd, bw))
    return dataclasses.replace(sg, graphs=graphs), m, origin


@timed_dispatch("slab_update", op="update_shards")
def _apply_epoch(views, ins, dels, *, roles, caps):
    """Apply one canonical batch to every view and close the epoch:
    ``(views, inserted_mask | None, deleted_mask | None)``, the masks
    over the forward view's batch.  Consumes the views."""
    fwd_del, tr_del, sym_del, fwd_ins, tr_ins, sym_ins = caps
    views = list(views)
    fidx = roles.index(FORWARD)
    ins_mask = del_mask = None

    if dels is not None:
        ds, dd = dels
        p = ds.shape[0]
        # forward first: the symmetric union asks the post-delete forward
        # view whether the reverse direction survives
        views[fidx], m, origin = _route_update(views[fidx], ds, dd, None,
                                               fwd_del, dels=True)
        del_mask = _scatter_back(m, origin, p)
        for i, role in enumerate(roles):
            if role == TRANSPOSE:
                views[i], _, _ = _route_update(views[i], dd, ds, None,
                                               tr_del, dels=True)
            elif role == SYMMETRIC:
                fwd = views[fidx]
                bs, bd, _, qorig, _ = _route_body(
                    dd, ds, None, n_shards=fwd.n_shards, cap=tr_del)
                gone = ~_scatter_back(query_shards(fwd.graphs, bs, bd),
                                      qorig, p)
                s2 = torch.cat([torch.where(gone, ds, INVALID_VERTEX),
                                torch.where(gone, dd, INVALID_VERTEX)])
                views[i], _, _ = _route_update(
                    views[i], s2, torch.cat([dd, ds]), None, sym_del,
                    dels=True)

    if ins is not None:
        s, d, w = ins
        views[fidx], m, origin = _route_update(views[fidx], s, d, w,
                                               fwd_ins, dels=False)
        ins_mask = _scatter_back(m, origin, s.shape[0])
        for i, role in enumerate(roles):
            if role == TRANSPOSE:
                views[i], _, _ = _route_update(views[i], d, s, w, tr_ins,
                                               dels=False)
            elif role == SYMMETRIC:
                views[i], _, _ = _route_update(
                    views[i], torch.cat([s, d]), torch.cat([d, s]),
                    None if w is None else torch.cat([w, w]), sym_ins,
                    dels=False)

    views = [dataclasses.replace(v, graphs=update_slab_pointers(v.graphs))
             for v in views]
    return tuple(views), ins_mask, del_mask


def _engine(sg: ShardedSlabGraph, s, d, w=None, *, dels: bool):
    """One routed ``(W,)`` engine batch on a mesh rank's shard; ``(sg,
    mask (1, W))``."""
    if dels:
        graphs, _, m = update_shards(sg.graphs, dels=(s[None], d[None]))
    else:
        graphs, m, _ = update_shards(
            sg.graphs, ins=(s[None], d[None], None if w is None else w[None]))
    return dataclasses.replace(sg, graphs=graphs), m


def _valid_first(n: int, invalid: torch.Tensor) -> torch.Tensor:
    """The first ``n`` positions of a stable valid-first order: the
    compaction that keeps a bucket's edges in global batch order."""
    return torch.sort(invalid.to(torch.uint8), stable=True).indices[:n]


@timed_dispatch("slab_update", op="update_shards")
def _apply_epoch_mesh(views, ins, dels, *, roles, caps):
    """The reference's ``shard_map`` epoch (``_sharded_apply_sm``) on this
    rank's shard of every view: ``(views, inserted_mask | None,
    deleted_mask | None)``, the masks over the whole batch and the same on
    every rank.  ``ins``/``dels`` are the padded canonical batch every
    rank holds (a multiple of S long); the rank routes its contiguous
    block.  ``caps`` holds (pair, total) caps for the forward and reverse
    routes and plain totals for the symmetric view, which routes nothing
    of its own: its candidates ride the forward and reverse exchanges.
    Consumes the views."""
    fwd_del, tr_del, sym_del, fwd_ins, tr_ins, sym_ins = caps
    views = list(views)
    fidx = roles.index(FORWARD)
    mesh, group = views[fidx].mesh, views[fidx].group
    S, me = views[fidx].n_shards, views[fidx].rank
    need_rev = len(roles) > 1
    ins_mask = del_mask = None

    def block(x):
        if x is None:
            return None
        n = x.shape[0] // S
        return x[me * n:(me + 1) * n]

    def route(s, d, w, cap):
        # pair buckets of (source block, owner), exchanged, then the
        # (S * cap_pair,) interior-padded flatten compacted valid first to
        # the total cap: the stacked rendering's bucket row
        cap_pair, cap_tot = cap
        bs, bd, bw, orig, _ = route_exchange(block(s), block(d), block(w),
                                             n_shards=S, cap=cap_pair,
                                             mesh=mesh)
        if cap_tot < bs.shape[0]:
            keep = _valid_first(cap_tot, orig < 0)
            bs, bd, orig = bs[keep], bd[keep], orig[keep]
            bw = None if bw is None else bw[keep]
        return bs, bd, bw, orig

    def compact(cap_tot, s, d, w=None):
        # the symmetric ride-along is compacted to its total cap only on a
        # 2x width cut (the engine's pools do not depend on the padding)
        if cap_tot * 2 > s.shape[0]:
            return s, d, w
        keep = _valid_first(cap_tot, s == INVALID_VERTEX)
        return s[keep], d[keep], None if w is None else w[keep]

    def kept(mask, s, d, orig):
        on = (orig >= 0) & mask[orig.clamp_min(0).long()]
        return (torch.where(on, s, INVALID_VERTEX),
                torch.where(on, d, INVALID_VERTEX))

    if dels is not None:
        ds, dd = dels
        n_del = ds.shape[0]
        bs, bd, _, orig = route(ds, dd, None, fwd_del)
        views[fidx], m = _engine(views[fidx], bs, bd, dels=True)
        del_part = _scatter_back(m, orig, n_del)
        if need_rev:
            # one reverse exchange feeds the transpose delete, the
            # reverse-existence query and the symmetric delete's reverse
            # half
            rbs, rbd, _, rorig = route(dd, ds, None, tr_del)
        for i, role in enumerate(roles):
            if role == TRANSPOSE:
                views[i], _ = _engine(views[i], rbs, rbd, dels=True)
            elif role == SYMMETRIC:
                found = query_shards(views[fidx].graphs, rbs[None], rbd[None])
                gone = ~or_across_shards(_scatter_back(found, rorig, n_del),
                                         group)
                fs, fd = kept(gone, bs, bd, orig)
                rs, rd = kept(gone, rbs, rbd, rorig)
                cs, cd, _ = compact(sym_del, torch.cat([fs, rs]),
                                    torch.cat([fd, rd]))
                views[i], _ = _engine(views[i], cs, cd, dels=True)
        del_mask = or_across_shards(del_part, group)

    if ins is not None:
        s, d, w = ins
        n_ins = s.shape[0]
        bs, bd, bw, orig = route(s, d, w, fwd_ins)
        views[fidx], m = _engine(views[fidx], bs, bd, bw, dels=False)
        ins_part = _scatter_back(m, orig, n_ins)
        if need_rev:
            tbs, tbd, tbw, _ = route(d, s, w, tr_ins)
        for i, role in enumerate(roles):
            if role == TRANSPOSE:
                views[i], _ = _engine(views[i], tbs, tbd, tbw, dels=False)
            elif role == SYMMETRIC:
                # the forward bucket holds this rank's (s, d) half and the
                # transpose bucket its (d, s) half: their concat is the
                # stacked rendering's symmetric bucket
                cs, cd, cw = compact(
                    sym_ins, torch.cat([bs, tbs]), torch.cat([bd, tbd]),
                    None if bw is None else torch.cat([bw, tbw]))
                views[i], _ = _engine(views[i], cs, cd, cw, dels=False)
        ins_mask = or_across_shards(ins_part, group)

    views = [dataclasses.replace(v, graphs=update_slab_pointers(v.graphs))
             for v in views]
    return tuple(views), ins_mask, del_mask


def _cap_rung(n: int) -> int:
    """Sticky-cap rungs: powers of two up to 256, multiples of 256 past
    that (a pure power-of-two ladder wastes up to 2x bucket width at
    large caps)."""
    if n <= 256:
        return next_pow2(n, lo=1)
    return -(-int(n) // 256) * 256


def _sym_concat_ids(a, b, p: int) -> np.ndarray:
    """Host (2p,) symmetric candidates: both halves padded to ``p`` with
    INVALID, as the epoch builds them on the device."""
    out = np.full(2 * p, np.uint32(0xFFFFFFFF), np.uint32)
    out[:len(a)] = a
    out[p:p + len(b)] = b
    return out


# ----------------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------------

#: a rank's outcome of a stage of a mesh epoch, all-reduced with MAX: a
#: simulated kill outranks an allocation failure, which outranks any other
_OK, _FAILED, _OOM, _KILLED = 0, 1, 2, 3


class MeshPeerFailure(RuntimeError):
    """Raised on the ranks of a mesh epoch that did not fail themselves when
    another rank did, so that every rank leaves the epoch together.
    ``killed``: the failure was a simulated kill (the WAL record stays, as
    after a kill of the whole job)."""

    def __init__(self, stage: str, killed: bool):
        super().__init__(f"another rank of the mesh failed in {stage}"
                         + (" (a simulated kill)" if killed else ""))
        self.stage = stage
        self.killed = killed


def _keeps_wal_record(exc: BaseException) -> bool:
    """A simulated kill, here or on another rank: the journaled batch stays
    in the WAL for recovery."""
    return isinstance(exc, faults.InjectedCrash) or (
        isinstance(exc, MeshPeerFailure) and exc.killed)


class ShardedGraphStore(VersionedStoreBase):
    """Forward, transpose and symmetric ShardedSlabGraph views as one
    versioned unit (``VersionedStoreBase``'s version, log, listener and
    maintenance protocol): stacked on one device, or, after
    ``place_on_mesh``, one shard a rank, every rank calling the same
    methods with the same arguments."""

    def __init__(self, views: Dict[str, ShardedSlabGraph], *, weighted: bool,
                 version: int = 0, log_capacity: int = 64,
                 maintenance=None, dispatch: str = "auto"):
        if FORWARD not in views:
            raise ValueError("a store always carries the forward view")
        unknown = set(views) - set(ALL_VIEWS)
        if unknown:
            raise ValueError(f"unknown views {unknown}")
        if dispatch not in ("auto", "vmap", "shard_map"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        super().__init__(version=version, log_capacity=log_capacity,
                         maintenance=maintenance)
        self._views = dict(views)
        self.weighted = bool(weighted)
        self.dispatch = dispatch
        self.device = views[FORWARD].device
        # host accounting: _high_water[name] bounds the view's worst-shard
        # next_free (one read to prime, then per-epoch routed-insert
        # counts); _sticky_caps[(mode, slot)] only ratchet up (reset at
        # maintenance), keyed as the reference's checkpoints key them;
        # recompile_count counts the distinct dispatch keys (mode, views,
        # caps, batch rungs, weights), the reference's jit
        # specialisations
        self._high_water: Dict[str, int] = {}
        self._sticky_caps: Dict[tuple, int] = {}
        self._dispatch_keys: set = set()
        self.recompile_count = 0

    # ------------------------------------------------------ mesh, dispatch
    def place_on_mesh(self, mesh) -> "ShardedGraphStore":
        """Pin every view's shards to the ``("shard",)`` mesh, one rank a
        shard (``distributed.sharded_graph.place_on_mesh``; every rank
        calls it on the same stacked store).  From then on
        ``dispatch="auto"`` runs epochs, queries and analytics as the
        multi-process rendering.  An attached WAL and audit policy stay
        attached: on the mesh rank 0 writes the WAL.  Returns self."""
        for name in list(self._views):
            self._views[name] = place_on_mesh(self._views[name], mesh)
        self.device = self.forward.device
        return self

    @property
    def mesh(self):
        return self.forward.mesh

    def _mode(self) -> str:
        """``"vmap"`` (stacked) or ``"shard_map"`` (mesh)."""
        return _resolve_dispatch(self.dispatch, self.mesh)

    def _agreed(self, stage: str, fn):
        """Run ``fn`` (a stage of an epoch that can fail) and, on a mesh,
        agree on the outcome with one all-reduce: when any rank failed,
        every rank raises (its own exception, or ``MeshPeerFailure``; an
        ``InjectedOOM`` as such, so that the retry budgets retry together),
        and no rank is left inside a collective.  Returns ``fn()``."""
        err, out = None, None
        try:
            out = fn()
        except BaseException as e:               # agreed on below
            err = e
        if self.mesh is None:
            if err is not None:
                raise err
            return out
        code = (_OK if err is None
                else _KILLED if isinstance(err, faults.InjectedCrash)
                else _OOM if isinstance(err, faults.InjectedOOM)
                else _FAILED)
        worst = int(max_across_shards(
            torch.tensor(code, device=self.device), self.forward.group))
        if worst == _OK:
            return out
        if err is not None:
            raise err
        if worst == _OOM:
            raise faults.InjectedOOM(stage, 0)
        raise MeshPeerFailure(stage, killed=worst == _KILLED)

    def _wal_append(self, i_s, i_d, i_w, d_s, d_d):
        """On a mesh rank 0 journals the canonical batch, which every rank
        holds; the other ranks hold no writer."""
        if self.mesh is not None and self.forward.rank != 0:
            return None
        return super()._wal_append(i_s, i_d, i_w, d_s, d_d)

    def _dump_postmortem(self, exc: BaseException) -> None:
        """On a mesh every rank reads the bundle's pool statistics (a
        gather), and rank 0 writes it."""
        if self.mesh is not None and self.forward.rank != 0:
            from ..obs import postmortem
            if postmortem.reads_store(self, exc):
                postmortem.store_section(self)
            return
        super()._dump_postmortem(exc)

    # ------------------------------------------------------- host accounting
    def _high(self, name: str) -> int:
        """Host bound on the view's worst-shard ``next_free`` (one read to
        prime, exact insert accounting afterwards)."""
        if name not in self._high_water:
            self._high_water[name] = worst_next_free(self._views[name])
        return self._high_water[name]

    def sweep_rows(self, view: str = FORWARD) -> int:
        """Row bound for the analytics' sweeps: the allocated-prefix bound
        rounded up to 256 rows."""
        cap = int(self._views[view].graphs.keys.shape[1])
        return min(cap, -(-self._high(view) // 256) * 256)

    def _cap(self, mode: str, slot: str, need: int) -> int:
        """Sticky routing cap: ratchets up only (reset at maintenance)."""
        cap = max(self._sticky_caps.get((mode, slot), 1), need)
        self._sticky_caps[(mode, slot)] = cap
        return cap

    def _route_metrics(self, i_s, d_s, S: int) -> None:
        """Per-shard forward route counts and the imbalance gauge (max over
        mean), with metrics on: one host bincount of the canonical batch,
        nothing read from the device."""
        for kind, arr in (("ins", i_s), ("del", d_s)):
            if not len(arr):
                continue
            counts = np.bincount(np.asarray(arr, np.int64) % S,
                                 minlength=S)
            for k in range(S):
                obs.inc(f"store.route.{kind}.shard{k}", int(counts[k]))
            mean = counts.mean()
            if mean > 0:
                obs.set_gauge(f"store.route.{kind}.imbalance",
                              float(counts.max() / mean))

    # ------------------------------------------------------------- construct
    @classmethod
    def from_edges(cls, n_vertices: int, n_shards: int, src, dst, w=None, *,
                   with_transpose: bool = True, with_symmetric: bool = True,
                   slack_slabs: int = 0, log_capacity: int = 64,
                   maintenance=None, dispatch: str = "auto",
                   device="cuda") -> "ShardedGraphStore":
        """Bulk-build every view on the host (``shard_from_edges_host``,
        one dedup shared) and move it to ``device`` (``cuda`` unless
        ``device="cpu"``)."""
        dev = resolve_device(device)
        src, dst, w = dedup_pairs(src, dst, w)
        kw = dict(slack_slabs=slack_slabs, device=dev)
        views = {FORWARD: shard_from_edges_host(
            n_vertices, n_shards, src, dst, w, **kw)}
        if with_transpose:
            views[TRANSPOSE] = shard_from_edges_host(
                n_vertices, n_shards, dst, src, w, **kw)
        if with_symmetric:
            w2 = None if w is None else np.concatenate([w, w])
            views[SYMMETRIC] = shard_from_edges_host(
                n_vertices, n_shards, np.concatenate([src, dst]),
                np.concatenate([dst, src]), w2, **kw)
        return cls(views, weighted=w is not None, log_capacity=log_capacity,
                   maintenance=maintenance, dispatch=dispatch)

    # ------------------------------------------------------------- accessors
    @property
    def forward(self) -> ShardedSlabGraph:
        return self._views[FORWARD]

    @property
    def transpose(self) -> Optional[ShardedSlabGraph]:
        return self._views.get(TRANSPOSE)

    @property
    def symmetric(self) -> Optional[ShardedSlabGraph]:
        return self._views.get(SYMMETRIC)

    @property
    def views(self) -> Dict[str, ShardedSlabGraph]:
        return dict(self._views)

    @property
    def n_shards(self) -> int:
        return self.forward.n_shards

    @property
    def n_vertices(self) -> int:
        return self.forward.n_vertices_global

    @property
    def n_edges(self) -> int:
        return int(sum_across_shards(self.forward.graphs.n_edges.sum(),
                                     self.forward.group))

    @property
    def out_degree(self) -> torch.Tensor:
        """Global out-degrees, reassembled from the forward shards."""
        return global_vector(self.forward, self.forward.graphs.degree)

    @property
    def in_degree(self) -> torch.Tensor:
        if self.transpose is None:
            raise ValueError("in-degrees live on the transpose view; build "
                             "the store with with_transpose=True")
        return global_vector(self.transpose, self.transpose.graphs.degree)

    # ----------------------------------------------------------------- apply
    def apply(self, ins_src=None, ins_dst=None, ins_w=None,
              del_src=None, del_dst=None) -> AppliedBatch:
        """Apply one mixed batch to every view and close the epoch.

        One host dedup, host-exact sticky routing caps (no overflow by
        construction), growth of the stacked pools from host accounting,
        then one fused epoch (``_apply_epoch``).  Validation, the WAL,
        retries, fault sites (``apply.admitted``, ``store.capacity_grow``
        when a view must grow, ``apply.post_wal``, ``apply.pre_close``,
        ``apply.post_close``), flight events, maintenance and audits are
        ``GraphStore.apply``'s."""
        validate_batch(ins_src, ins_dst, ins_w, del_src, del_dst,
                       n_vertices=self.n_vertices)
        t0 = time.perf_counter()
        epoch_span = obs.span("store.apply", version=self.version,
                              sharded=True)
        epoch_span.__enter__()
        try:
            batch = self._apply_inner(epoch_span, ins_src, ins_dst, ins_w,
                                      del_src, del_dst)
        except BaseException as e:
            # a failed apply may have moved the pools before it failed:
            # re-read the live edge count rather than trust the log's
            self._n_edges_host = None
            self._dump_postmortem(e)
            raise
        finally:
            epoch_span.__exit__(None, None, None)
        if obs.metrics.enabled():
            obs.observe("store.apply", time.perf_counter() - t0)
            obs.inc("store.apply.epochs")
            obs.inc("store.apply.inserted", batch.n_inserted)
            obs.inc("store.apply.deleted", batch.n_deleted)
        self._auto_maintain()
        self._auto_audit()
        return batch

    def _apply_inner(self, epoch_span, ins_src, ins_dst, ins_w, del_src,
                     del_dst) -> AppliedBatch:
        def admit():
            with obs.span("store.apply.host_dedup"):
                batch = canonical_batch(ins_src, ins_dst, ins_w, del_src,
                                        del_dst, weighted=self.weighted)
            faults.fault_point("apply.admitted", version=self.version)
            return batch

        i_s, i_d, i_w, d_s, d_d = self._agreed("apply.admitted", admit)
        _flight.record(_FL_ADMIT, self.version, len(i_s), len(d_s))
        roles = tuple(v for v in ALL_VIEWS if v in self._views)
        S = self.n_shards
        mode = self._mode()
        if obs.metrics.enabled():
            self._route_metrics(i_s, d_s, S)

        def padded(n):
            # power-of-two batch rungs, a multiple of S
            return -(-next_pow2(n) // S) * S

        p_del = padded(len(d_s)) if len(d_s) else 0
        p_ins = padded(len(i_s)) if len(i_s) else 0

        def cap_of(slot, arr, block=None):
            # the total cap (the stacked bucket width); on a mesh the
            # forward and reverse routes also carry the (source block,
            # owner) pair cap their all-to-all buckets route through
            tot = (1 if not len(arr) else
                   self._cap(mode, slot, _cap_rung(max_owner_count(arr, S))))
            if mode != "shard_map" or block is None:
                return tot
            pair = (1 if not len(arr) else
                    self._cap(mode, slot + "_pair",
                              routing_cap_blocks(arr, S, block)))
            return (pair, tot)

        with obs.span("store.apply.route", mode=mode):
            one = (1, 1) if mode == "shard_map" else 1
            fwd_ins = tr_ins = fwd_del = tr_del = one
            sym_ins = sym_del = 1
            if len(d_s):
                fwd_del = cap_of("fwd_del", d_s, p_del // S)
                tr_del = cap_of("tr_del", d_d, p_del // S)
                sym_del = cap_of("sym_del", _sym_concat_ids(d_s, d_d, p_del))
            if len(i_s):
                fwd_ins = cap_of("fwd_ins", i_s, p_ins // S)
                tr_ins = cap_of("tr_ins", i_d, p_ins // S)
                sym_ins = cap_of("sym_ins", _sym_concat_ids(i_s, i_d, p_ins))
                per_view = {
                    FORWARD: max_owner_count(i_s, S),
                    TRANSPOSE: max_owner_count(i_d, S),
                    SYMMETRIC: max_owner_count(np.concatenate([i_s, i_d]),
                                               S)}

                def _ensure(name):
                    reserve = next_pow2(per_view[name], lo=1) + 64
                    sg = self._views[name]
                    cap_before = int(sg.graphs.keys.shape[1])
                    if cap_before - self._high(name) < reserve:
                        # the running bound charges a whole slab per routed
                        # insert; re-prime it with one exact read before
                        # paying for growth
                        self._agreed("store.capacity_grow", partial(
                            faults.fault_point, "store.capacity_grow",
                            view=name, version=self.version))
                        self._high_water[name] = worst_next_free(sg)
                        self._views[name] = ensure_capacity_sharded(
                            sg, reserve, high=self._high_water[name])
                        cap_after = int(
                            self._views[name].graphs.keys.shape[1])
                        if cap_after != cap_before:
                            obs.instant("capacity_grow", view=name,
                                        before=cap_before, after=cap_after)
                            obs.emit_event("capacity_grow", view=name,
                                           version=self.version,
                                           before=cap_before,
                                           after=cap_after)
                            obs.inc("store.capacity_grow")
                            _flight.record(_FL_GROW, self.version,
                                           cap_after)
                    self._last_reserve[name] = reserve

                for name in roles:
                    run_with_retries(partial(_ensure, name),
                                     budget=self.retry,
                                     site="store.capacity_grow")
            caps = (fwd_del, tr_del, sym_del, fwd_ins, tr_ins, sym_ins)

        dev = self.device
        del_sj = del_dj = ins_sj = ins_dj = ins_wj = None
        dels = ins = None
        if len(d_s):
            del_sj, del_dj = _pad_ids(d_s, p_del, dev), _pad_ids(d_d, p_del,
                                                                 dev)
            dels = (del_sj, del_dj)
        if len(i_s):
            ins_sj, ins_dj = _pad_ids(i_s, p_ins, dev), _pad_ids(i_d, p_ins,
                                                                 dev)
            ins_wj = _pad_f32(i_w, p_ins, dev)
            ins = (ins_sj, ins_dj, ins_wj)

        # durability: journal the canonical batch, then run the engine (on
        # a mesh rank 0 journals; a failure on any rank after the append
        # rolls its record back unless it was a kill)
        wal_token = None

        def journal():
            nonlocal wal_token
            wal_token = self._wal_append(i_s, i_d, i_w, d_s, d_d)
            faults.fault_point("apply.post_wal", version=self.version)

        def rollback(e):
            if wal_token is not None and not _keeps_wal_record(e):
                self.wal.rollback(wal_token)

        try:
            self._agreed("apply.post_wal", journal)
        except BaseException as e:
            # on a mesh another rank's failure here must not leave rank 0's
            # record behind; the stacked store keeps the reference's
            # behaviour (a failure at this site keeps the record)
            if self.mesh is not None:
                rollback(e)
            raise
        _flight.record(_FL_POST_WAL, self.version,
                       0 if wal_token is None else 1)

        def dispatch():
            n_inserted = n_deleted = 0
            ins_mask = del_mask = None
            if ins is not None or dels is not None:
                key = (mode, roles, caps, p_del, p_ins, i_w is not None)
                if key not in self._dispatch_keys:
                    self._dispatch_keys.add(key)
                    self.recompile_count += 1
                    obs.inc("store.sharded.recompiles")
                    obs.instant("sharded_recompile", mode=mode)
                epoch = (_apply_epoch_mesh if mode == "shard_map"
                         else _apply_epoch)
                with obs.span("store.apply.dispatch", mode=mode,
                              version=self.version, views=len(roles)):
                    new_views, ins_mask, del_mask = epoch(
                        tuple(self._views[r] for r in roles), ins, dels,
                        roles=roles, caps=caps)
                    for r, v in zip(roles, new_views):
                        self._views[r] = v
                    if del_mask is not None:
                        n_deleted = int(del_mask.sum())
                    if ins_mask is not None:
                        n_inserted = int(ins_mask.sum())
                # exact host accounting: the worst shard opens at most its
                # routed insert count of new slabs this epoch
                if len(i_s):
                    for name in roles:
                        self._high_water[name] = (self._high(name)
                                                  + per_view[name])
            faults.fault_point("apply.pre_close", version=self.version)
            return n_inserted, n_deleted, ins_mask, del_mask

        def close():
            _flight.record(_FL_DISPATCH, self.version,
                           n_inserted, n_deleted)
            with obs.span("store.apply.notify"):
                batch = self._record_batch(
                    ins_src=ins_sj, ins_dst=ins_dj, ins_w=ins_wj,
                    ins_mask=ins_mask, del_src=del_sj, del_dst=del_dj,
                    del_mask=del_mask, n_inserted=n_inserted,
                    n_deleted=n_deleted)
            # the epoch closed inside the fused epoch; an empty batch (no
            # epoch ran) closes here, a no-op on the values
            if ins is None and dels is None:
                with obs.span("store.apply.epoch_close"):
                    for name, sg in self._views.items():
                        self._views[name] = dataclasses.replace(
                            sg, graphs=update_slab_pointers(sg.graphs))
            faults.fault_point("apply.post_close", version=self.version)
            _flight.record(_FL_CLOSE, batch.version,
                           n_inserted, n_deleted)
            return batch

        try:
            n_inserted, n_deleted, ins_mask, del_mask = self._agreed(
                "apply.pre_close", dispatch)
            batch = self._agreed("apply.post_close", close)
        except BaseException as e:
            rollback(e)        # a simulated kill: the WAL record survives
            raise
        epoch_span.annotate(inserted=n_inserted, deleted=n_deleted)
        return batch

    # ----------------------------------------------------- maintenance plane
    def pool_stats(self, view: str = FORWARD, *, chains: bool = True
                   ) -> dict:
        """Pool health over the view's shards (per-shard
        ``core.pool_stats`` summed or maxed, so the policy's thresholds
        read as on the unsharded store; the capacity is per shard).  On a
        mesh the ranks' shard stats are gathered first, so every rank
        reads the same numbers and takes the same maintenance decision."""
        sg = self._views[view]
        if sg.mesh is None:
            per = [pool_stats(shard_slice(sg, k), chains=chains)
                   for k in range(self.n_shards)]
        else:
            per = gather_objects(
                pool_stats(shard_slice(sg, sg.rank), chains=chains),
                sg.group)
        live = sum(p["live_lanes"] for p in per)
        tomb = sum(p["tombstone_lanes"] for p in per)
        alloc = sum(p["allocated_slabs"] for p in per)
        out = {
            "capacity_slabs": per[0]["capacity_slabs"],
            "next_free": max(p["next_free"] for p in per),
            "free_top": min(p["free_top"] for p in per),
            "free_slabs": min(p["free_slabs"] for p in per),
            "allocated_slabs": alloc,
            "dead_slabs": sum(p["dead_slabs"] for p in per),
            "live_lanes": live,
            "tombstone_lanes": tomb,
            "tombstone_ratio": tomb / max(1, live + tomb),
            "occupancy": live / max(1, alloc * SLAB_WIDTH),
            "pool_bytes": sum(p["pool_bytes"] for p in per),
            "n_edges": sum(p["n_edges"] for p in per),
            "per_shard": per,
        }
        if chains:
            out["max_chain"] = max(p["max_chain"] for p in per)
            out["mean_chain"] = float(np.mean([p["mean_chain"]
                                               for p in per]))
        return out

    def _compact_view(self, sg: ShardedSlabGraph, *, shrink: bool,
                      slack_slabs: int):
        if sg.mesh is None:
            graphs, rep = compact_shards(sg.graphs, shrink=shrink,
                                         slack_slabs=slack_slabs)
            return dataclasses.replace(sg, graphs=graphs), rep
        # every rank lands on one capacity and reads one report

        def across(x, reduce=max_across_shards) -> int:
            return int(reduce(torch.as_tensor(x, device=sg.device),
                              sg.group))

        old_next_free = across(sg.graphs.next_free.max())
        graphs, rep = compact_shards(sg.graphs, shrink=shrink,
                                     slack_slabs=slack_slabs,
                                     agree_need=across)
        rep = dataclasses.replace(
            rep, live_lanes=across(rep.live_lanes, sum_across_shards),
            old_next_free=old_next_free,
            new_next_free=across(graphs.next_free.max()))
        return dataclasses.replace(sg, graphs=graphs), rep

    def _reclaim_view(self, sg: ShardedSlabGraph):
        graphs, n = reclaim_shards(sg.graphs)
        if sg.mesh is not None:
            n = int(sum_across_shards(torch.tensor(n, device=sg.device),
                                      sg.group))
        return dataclasses.replace(sg, graphs=graphs), n

    def _maintain_views(self, action: str, policy, *, shrink: bool):
        out = super()._maintain_views(action, policy, shrink=shrink)
        # slabs moved (and pools may have shrunk): the host bounds and the
        # sticky caps are stale; the next epoch re-primes them
        self._high_water.clear()
        self._sticky_caps.clear()
        return out

    # --------------------------------------------------------------- queries
    def query(self, src, dst) -> np.ndarray:
        """Batched membership against the sharded forward view (host
        arrays in, host bool array out, trimmed to the query length).  On
        a mesh the queries route through ``route_exchange`` (buckets of
        the exact largest (source block, owner) count) and every rank
        gets every answer."""
        from ..distributed.sharded_graph import query_edges_sharded
        src = np.asarray(src, np.uint32)
        dst = np.asarray(dst, np.uint32)
        S = self.n_shards
        p = next_pow2(max(len(src), 1))
        if self.mesh is None:
            cap = routing_cap(src, S)
        else:
            p = -(-p // S) * S
            cap = routing_cap_blocks(src, S, p // S)
        found = query_edges_sharded(
            self.forward, _pad_ids(src, p, self.device),
            _pad_ids(dst, p, self.device), cap=cap)
        return found.cpu().numpy()[:len(src)]

    def neighbors(self, vertices, *, out_capacity: int = 4096
                  ) -> EdgeFrontier:
        """Current out-edges of ``vertices`` as one EdgeFrontier: chain
        walks on each owner shard, src ids made global again, merged in
        shard order (on a mesh each rank walks its own shard and the
        walks are gathered, so every rank returns the same frontier)."""
        vertices = np.asarray(vertices, np.uint32)
        S = self.n_shards
        cap = next_pow2(out_capacity)

        def walk(k):
            m = (vertices % np.uint32(S)) == k
            if not m.any():
                return None
            g = shard_slice(self.forward, k)
            loc = (vertices[m] // np.uint32(S)).astype(np.uint32)
            p = next_pow2(max(len(loc), 1))
            vmask = torch.from_numpy(np.arange(p) < len(loc)).to(
                self.device)
            ef = expand_vertices(g, _pad_ids(loc, p, self.device), vmask,
                                 out_capacity=cap, max_bpv=1)
            n = int(ef.size)
            return (ef.src[:n].cpu().numpy().astype(np.int64) * S + k,
                    ef.dst[:n].cpu().numpy(), ef.weight[:n].cpu().numpy(),
                    bool(ef.overflow))

        fwd = self.forward
        parts = ([walk(k) for k in range(S)] if fwd.mesh is None
                 else gather_objects(walk(fwd.rank), fwd.group))
        parts = [x for x in parts if x is not None]
        srcs = [x[0] for x in parts]
        dsts = [x[1] for x in parts]
        ws = [x[2] for x in parts]
        overflow = any(x[3] for x in parts)
        src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
        n = min(len(src), cap)
        overflow = overflow or len(src) > cap
        out_src = np.zeros(cap, np.int32)
        out_dst = np.zeros(cap, np.int32)
        out_w = np.zeros(cap, np.float32)
        out_src[:n] = src[:n].astype(np.uint32).view(np.int32)
        if srcs:
            out_dst[:n] = np.concatenate(dsts)[:n]
            out_w[:n] = np.concatenate(ws)[:n]
        dev = self.device
        return EdgeFrontier(
            torch.from_numpy(out_src).to(dev),
            torch.from_numpy(out_dst).to(dev),
            torch.from_numpy(out_w).to(dev),
            torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(overflow, device=dev))

    # ------------------------------------------------------------ checkpoint
    def _resilience_meta(self) -> dict:
        # the host accounting steers growth: a replay after restore makes
        # the crashed process's growth decisions (pool shapes included)
        meta = super()._resilience_meta()
        meta["high_water"] = {k: int(v)
                              for k, v in self._high_water.items()}
        meta["sticky_caps"] = [[m, s, int(c)]
                               for (m, s), c in self._sticky_caps.items()]
        return meta

    def _adopt_resilience_meta(self, meta: dict) -> None:
        super()._adopt_resilience_meta(meta)
        res = meta.get("resilience") or {}
        self._high_water = {k: int(v)
                            for k, v in res.get("high_water", {}).items()}
        self._sticky_caps = {(m, s): int(c)
                             for m, s, c in res.get("sticky_caps", [])}

    def save(self, ckpt_dir, step: Optional[int] = None, *, registry=None,
             extra: Optional[dict] = None, keep_last: int = 3):
        """Persist every view's stacked pools and the property states
        atomically, in the reference's sharded-store format, and drop the
        WAL segments the checkpoint covers.  On a mesh every rank calls
        it: the shards are gathered and rank 0 writes what the stacked
        store writes and truncates the WAL (every rank returns its
        path)."""
        from ..checkpoint import ckpt
        mesh = self.mesh
        step = self.version if step is None else int(step)
        props = {} if registry is None else registry.states()
        prop_versions = {} if registry is None else registry.versions()
        meta = {
            "stream_store": True,
            "sharded_store": True,
            "version": int(self.version),
            "n_vertices": int(self.n_vertices),
            "n_shards": int(self.n_shards),
            "weighted": bool(self.weighted),
            "views": {name: int(sg.graphs.n_buckets)
                      for name, sg in self._views.items()},
            "prop_versions": {k: int(v) for k, v in prop_versions.items()},
            "resilience": self._resilience_meta(),
        }
        if extra:
            meta.update(extra)
        views = {name: sg.graphs for name, sg in self._views.items()}
        if mesh is not None:
            group = self.forward.group
            views = {name: dataclasses.replace(g, **{
                f: None if getattr(g, f) is None
                else gather_stacked(getattr(g, f)[0], group).cpu()
                for f in FIELDS}) for name, g in views.items()}
            path = None
            if self.forward.rank == 0:
                path = ckpt.save(ckpt_dir, step,
                                 {"views": views, "props": props},
                                 extra=meta, keep_last=keep_last)
                if self.wal is not None and step == self.version:
                    self.wal.truncate(self.version)
            dist.barrier(group=group)
            return gather_objects(path, group)[0]
        path = ckpt.save(ckpt_dir, step, {"views": views, "props": props},
                         extra=meta, keep_last=keep_last)
        if self.wal is not None and step == self.version:
            self.wal.truncate(self.version)
        return path

    @classmethod
    def restore(cls, ckpt_dir, *, step: Optional[int] = None,
                specs: Sequence = (),
                policies: Optional[Dict[str, str]] = None,
                log_capacity: int = 64, maintenance=None,
                dispatch: str = "auto", device="cuda"):
        """Rebuild ``(store, registry)`` from a sharded checkpoint on
        ``device`` (``cuda`` unless the caller passes ``"cpu"``): the
        ``GraphStore.restore`` contract."""
        from ..checkpoint import ckpt
        from ..checkpoint.ckpt import CheckpointError
        dev = resolve_device(device)
        manifest = ckpt.read_manifest(ckpt_dir, step=step)
        meta = manifest["extra"]
        missing = [k for k in ("n_vertices", "n_shards", "weighted",
                               "views", "prop_versions") if k not in meta]
        if missing or not meta.get("sharded_store"):
            raise CheckpointError(
                f"{ckpt_dir} step {manifest['step']} is not a "
                f"ShardedGraphStore checkpoint (missing meta: "
                f"{missing or ['sharded_store']}); pick another step= "
                "or re-checkpoint")
        V = int(meta["n_vertices"])
        S = int(meta["n_shards"])
        weighted = bool(meta["weighted"])
        n_local = -(-V // S)

        def view_like(n_buckets: int) -> SlabGraph:
            dtypes = {f: torch.int32 for f in FIELDS}
            dtypes.update(weights=torch.float32 if weighted else None,
                          upd_flag=torch.bool, slab_new=torch.bool)
            return SlabGraph(**dtypes, n_vertices=n_local,
                             n_buckets=int(n_buckets), weighted=weighted)

        like_views = {name: view_like(nb)
                      for name, nb in meta["views"].items()}
        spec_by_name = {s.name: s for s in specs}
        like_props = {}
        for name in meta["prop_versions"]:
            spec = spec_by_name.get(name)
            if spec is None or spec.state_like is None:
                raise KeyError(
                    f"checkpoint stores property {name!r}; pass its "
                    f"PropertySpec (with a state_like) via specs= to "
                    f"restore it")
            like_props[name] = spec.state_like(V)
        tree, _ = ckpt.restore(ckpt_dir, {"views": like_views,
                                          "props": like_props},
                               step=manifest["step"], device=dev)
        views = {name: ShardedSlabGraph(graphs=graphs, n_shards=S,
                                        n_vertices_global=V)
                 for name, graphs in tree["views"].items()}
        store = cls(views, weighted=weighted, version=meta["version"],
                    log_capacity=log_capacity, maintenance=maintenance,
                    dispatch=dispatch)
        store._adopt_resilience_meta(meta)

        registry = None
        if spec_by_name:
            from .properties import PropertyRegistry
            registry = PropertyRegistry(store)
            policies = policies or {}
            for name, spec in spec_by_name.items():
                if name in tree["props"]:
                    registry.register(spec,
                                      policy=policies.get(name, "lazy"),
                                      _state=tree["props"][name],
                                      _version=meta["prop_versions"][name])
                else:
                    registry.register(spec, policy=policies.get(name, "lazy"))
        return store, registry


# ----------------------------------------------------------------------------
# sharded stream_property hooks (registered via PropertyRegistry)
# ----------------------------------------------------------------------------

def sharded_pagerank_property(*, damping: float = 0.85,
                              error_margin: float = 1e-5,
                              max_iter: int = 100):
    """PropertySpec: PageRank over the sharded transpose view with the
    global out-degrees; every batch is a warm start, so lazy catch-up runs
    it once."""
    from .properties import PropertySpec

    def _run(store, init_pr=None):
        if store.transpose is None:
            raise ValueError("sharded pagerank sweeps the transpose view; "
                             "build the store with with_transpose=True")
        pr, _ = pagerank_sharded(store.transpose, store.out_degree,
                                 init_pr=init_pr, damping=damping,
                                 error_margin=error_margin,
                                 max_iter=max_iter,
                                 rows=store.sweep_rows(TRANSPOSE))
        return pr

    return PropertySpec(
        name="pagerank",
        init=lambda store: _run(store),
        on_batch=lambda store, state, batch: _run(store, init_pr=state),
        refresh=lambda store: _run(store),
        state_like=lambda n: torch.zeros(n, dtype=torch.float32),
        collapse_replay=True)


def sharded_wcc_property(*, max_iters: int = 100000):
    """PropertySpec: minimum-id component labels by sharded min-label
    sweeps over the symmetric view.  Insert-only epochs warm start from
    the labels; an epoch that deletes recomputes (decremental WCC stays
    open, paper §6.4)."""
    from .properties import PropertySpec

    def _run(store, init_labels=None):
        if store.symmetric is None:
            raise ValueError("sharded wcc sweeps the symmetric view; build "
                             "the store with with_symmetric=True")
        labels, _ = wcc_sharded(store.symmetric, init_labels=init_labels,
                                max_iters=max_iters,
                                rows=store.sweep_rows(SYMMETRIC))
        return labels

    def _on_batch(store, labels, batch):
        if batch.n_deleted > 0:
            return _run(store)
        return _run(store, init_labels=labels)

    return PropertySpec(
        name="wcc", init=_run, on_batch=_on_batch, refresh=_run,
        state_like=lambda n: torch.zeros(n, dtype=torch.int32))


def sharded_bfs_property(src: int, *, max_iters: int = 100000):
    """PropertySpec: BFS levels from ``src`` by sharded unit ``min_plus``
    sweeps over the transpose view.  Insert-only epochs warm start from
    the levels; deleting epochs recompute.  Needs an unweighted store."""
    from .properties import PropertySpec

    def _run(store, init_dist=None):
        if store.weighted:
            raise ValueError("sharded_bfs_property needs an unweighted "
                             "store")
        if store.transpose is None:
            raise ValueError("sharded bfs sweeps the transpose view; build "
                             "the store with with_transpose=True")
        dist, _ = bfs_sharded(store.transpose, src=src, init_dist=init_dist,
                              max_iters=max_iters,
                              rows=store.sweep_rows(TRANSPOSE))
        return dist

    def _on_batch(store, dist, batch):
        if batch.n_deleted > 0:
            return _run(store)
        return _run(store, init_dist=dist)

    return PropertySpec(
        name=f"bfs_{src}", init=_run, on_batch=_on_batch, refresh=_run,
        state_like=lambda n: torch.zeros(n, dtype=torch.int32))


def sharded_triangle_property(*, impl: str = "auto"):
    """PropertySpec: the live global triangle count over the sharded
    symmetric view (a 0-d int64 tensor).  Epochs that change the edge set
    recount; maintenance and empty epochs keep the count."""
    from .properties import PropertySpec

    def _run(store):
        if store.symmetric is None:
            raise ValueError("sharded triangle counting probes the "
                             "symmetric view; build the store with "
                             "with_symmetric=True")
        return triangles_sharded(store.symmetric, impl=impl)

    def _on_batch(store, count, batch):
        if batch.maintenance or (batch.n_inserted == 0
                                 and batch.n_deleted == 0):
            return count
        return _run(store)

    return PropertySpec(
        name="triangles", init=_run, on_batch=_on_batch, refresh=_run,
        state_like=lambda n: torch.zeros((), dtype=torch.int64),
        collapse_replay=True)


__all__ = ["ShardedGraphStore", "sharded_pagerank_property",
           "sharded_wcc_property", "sharded_bfs_property",
           "sharded_triangle_property"]
