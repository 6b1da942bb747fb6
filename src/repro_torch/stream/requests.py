"""Typed requests and the batched pipeline that serves them.

* consecutive ``UpdateBatch`` requests coalesce (per edge the last
  operation wins, as sequential application would have it) into one
  ``GraphStore.apply``,
* consecutive ``MembershipQuery`` requests merge into one query and split
  back per request,
* ``PropertyRead`` reads the registry (lazy properties catch up here).

Every request gets a ``Response`` with the store version it observed and
its latency.  Malformed requests and recoverable apply failures
(``QuarantinedBatch``, ``RetryExhausted``, ``InjectedOOM``) come back as
structured ``kind="error"`` responses and the pipeline serves the rest of
the sequence; an ``InjectedCrash`` (a simulated kill) unwinds.  An
optional ``CircuitBreaker`` sheds update groups after K consecutive apply
failures; while it is open a ``PropertyRead`` serves the registry's
``peek``, a version-tagged and possibly stale state, instead of forcing a
catch-up through a failing store.  An optional ``obs.health.HealthEngine``
is fed every served request; every ``health_every`` dispatches the
pipeline samples the store and the registry, builds a report and hands it
to the breaker, which sheds updates once the worst burn rate reaches its
``burn_threshold``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import obs
from ..obs import flight as _flight
from ..obs import postmortem as _postmortem
from ..resilience.faults import InjectedCrash
from ..resilience.guard import (OPEN, PIPELINE_RECOVERABLE, CircuitBreaker,
                                QuarantinedBatch)
from .properties import PropertyRegistry
from .store import GraphStore

# one flight code per request class: the black box records every served
# request (class, latency ns, group size) even with metrics off
_FL_REQ = {k: _flight.intern(f"pipeline.{k}")
           for k in ("update", "member", "neighbors", "property",
                     "error", "shed")}


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """Mixed edge update: deletes apply before inserts."""
    ins_src: Any = ()
    ins_dst: Any = ()
    ins_w: Any = None
    del_src: Any = ()
    del_dst: Any = ()


@dataclasses.dataclass(frozen=True)
class MembershipQuery:
    src: Any
    dst: Any


@dataclasses.dataclass(frozen=True)
class NeighborsQuery:
    vertices: Any
    out_capacity: int = 4096


@dataclasses.dataclass(frozen=True)
class PropertyRead:
    name: str


Request = Union[UpdateBatch, MembershipQuery, NeighborsQuery, PropertyRead]


@dataclasses.dataclass
class Response:
    kind: str
    version: int
    payload: Dict[str, Any]
    latency_s: float


def coalesce_updates(batches: Sequence[UpdateBatch]) -> UpdateBatch:
    """Net a run of update batches into one equivalent batch.

    Within a batch deletes precede inserts and batches apply in order, so
    per edge the last operation decides.  An edge deleted and re-inserted
    stays in the delete list too, so the re-insert lands its new weight.
    """
    srcs, dsts, ws, ops = [], [], [], []
    for b in batches:
        d_s = np.asarray(b.del_src, np.uint32)
        if len(d_s):
            srcs.append(d_s)
            dsts.append(np.asarray(b.del_dst, np.uint32))
            ws.append(np.zeros(len(d_s), np.float32))
            ops.append(np.zeros(len(d_s), np.int8))
        i_s = np.asarray(b.ins_src, np.uint32)
        if len(i_s):
            srcs.append(i_s)
            dsts.append(np.asarray(b.ins_dst, np.uint32))
            ws.append(np.ones(len(i_s), np.float32) if b.ins_w is None
                      else np.asarray(b.ins_w, np.float32))
            ops.append(np.ones(len(i_s), np.int8))
    if not srcs:
        return UpdateBatch()
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    w = np.concatenate(ws)
    op = np.concatenate(ops)
    key = (src.astype(np.uint64) << np.uint64(32)) | dst.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    k_s = key[order]
    start = np.ones(len(k_s), bool)
    start[1:] = k_s[1:] != k_s[:-1]
    last = np.ones(len(k_s), bool)
    last[:-1] = start[1:]
    take = order[last]
    ins = op[take] == 1
    had_del = np.minimum.reduceat(op[order], np.nonzero(start)[0]) == 0
    has_w = any(b.ins_w is not None for b in batches)
    deleted = ~ins | (ins & had_del)
    return UpdateBatch(
        ins_src=src[take][ins], ins_dst=dst[take][ins],
        ins_w=w[take][ins] if has_w else None,
        del_src=src[take][deleted], del_dst=dst[take][deleted])


class RequestPipeline:
    """Serves a request sequence against (store, registry) with coalescing
    and query batching; responses align one to one with the requests.
    Latencies are taken after the device has finished the request's work."""

    def __init__(self, store: GraphStore,
                 registry: Optional[PropertyRegistry] = None, *,
                 coalesce: bool = True, batch_membership: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 health=None, health_every: int = 16):
        self.store = store
        self.registry = registry
        self.coalesce = coalesce
        self.batch_membership = batch_membership
        #: optional overload valve: updates shed while it is open, reads
        #: serve version-tagged stale states
        self.breaker = breaker
        #: optional obs.health.HealthEngine: fed every served request, and
        #: every ``health_every`` dispatches it reports (to the breaker,
        #: when one is armed)
        self.health = health
        self.health_every = int(health_every)
        self._since_health = 0
        if breaker is not None:
            # post-mortem bundles carry the breaker's state
            _postmortem.register_breaker(breaker)

    def _sync(self) -> None:
        if self.store.device.type == "cuda":
            torch.cuda.synchronize(self.store.device)

    def _apply_updates(self, group: List[UpdateBatch]) -> Dict[str, Any]:
        net = group[0] if len(group) == 1 else coalesce_updates(group)
        applied = self.store.apply(net.ins_src, net.ins_dst, net.ins_w,
                                   net.del_src, net.del_dst)
        return {"inserted": applied.n_inserted, "deleted": applied.n_deleted,
                "coalesced": len(group)}

    def _run_membership(self, group: List[MembershipQuery]) -> List[dict]:
        src = np.concatenate([np.asarray(q.src, np.uint32) for q in group])
        dst = np.concatenate([np.asarray(q.dst, np.uint32) for q in group])
        found = self.store.query(src, dst)
        out, at = [], 0
        for q in group:
            n = len(np.asarray(q.src))
            out.append({"found": found[at:at + n],
                        "hits": int(found[at:at + n].sum()),
                        "merged": len(group)})
            at += n
        return out

    def _observe(self, kind: str, dt: float, group: int = 1, *,
                 cls: Optional[str] = None, ok: bool = True) -> None:
        """The flight record and the health sample of one served request
        (always), and its latency and counts (with metrics on).  ``cls``
        names the SLO class where ``kind`` is an outcome (``error``,
        ``shed``)."""
        _flight.record(_FL_REQ[kind], int(1e9 * dt), group)
        if self.health is not None:
            self.health.observe_request(cls or kind, dt, ok=ok)
            self._since_health += 1
            if self._since_health >= self.health_every:
                self._since_health = 0
                self.health.observe_store(self.store)
                if self.registry is not None:
                    self.health.observe_staleness(self.registry)
                report = self.health.report()
                if self.breaker is not None:
                    self.breaker.note_health(report)
        if not obs.metrics.enabled():
            return
        obs.observe(f"pipeline.latency.{kind}", dt)
        obs.inc(f"pipeline.requests.{kind}", group)
        obs.inc(f"pipeline.dispatches.{kind}")
        if group > 1:
            obs.inc(f"pipeline.coalesced.{kind}", group - 1)

    def _fail(self, exc: BaseException, dt: float) -> Response:
        """Structured error response for one recoverable failure."""
        payload: Dict[str, Any] = {"error": type(exc).__name__,
                                   "detail": str(exc)}
        if isinstance(exc, QuarantinedBatch):
            payload["reasons"] = exc.reasons
        obs.inc("pipeline.errors.update")
        return Response("error", self.store.version, payload, dt)

    def _run_updates(self, group: List[UpdateBatch]) -> List[Response]:
        t0 = time.perf_counter()
        if self.breaker is not None and not self.breaker.allow():
            self.breaker.shed()
            dt = time.perf_counter() - t0
            self._observe("shed", dt, len(group), cls="update", ok=False)
            payload = {"error": "circuit_open", "shed": True,
                       "breaker": self.breaker.status()}
            return [Response("error", self.store.version, payload, dt)
                    for _ in group]
        try:
            with obs.span("pipeline.update", coalesced=len(group)):
                payload = self._apply_updates(group)
                self._sync()
        except InjectedCrash:
            raise                  # a simulated kill: nothing catches it
        except PIPELINE_RECOVERABLE as e:
            if self.breaker is not None:
                self.breaker.record_failure()
            dt = time.perf_counter() - t0
            self._observe("error", dt, len(group), cls="update", ok=False)
            return [self._fail(e, dt)] * len(group)
        if self.breaker is not None:
            self.breaker.record_success()
        dt = time.perf_counter() - t0
        self._observe("update", dt, len(group))
        return [Response("update", self.store.version, payload, dt)
                for _ in group]

    def _read_property(self, name: str) -> Response:
        t0 = time.perf_counter()
        if self.registry is None:
            return Response("error", self.store.version,
                            {"error": "no_registry",
                             "detail": "PropertyRead requires a "
                                       "PropertyRegistry"},
                            time.perf_counter() - t0)
        if self.breaker is not None and self.breaker.state == OPEN:
            # the store is shedding writes: serve the last good state,
            # tagged with the version it holds for
            value, version = self.registry.peek(name)
            dt = time.perf_counter() - t0
            self._observe("property", dt)
            obs.inc("pipeline.stale_reads")
            return Response("property", version,
                            {"name": name, "value": value, "stale": True,
                             "staleness": self.store.version - version}, dt)
        with obs.span("pipeline.property", prop=name):
            value = self.registry.read(name)
            self._sync()
        dt = time.perf_counter() - t0
        self._observe("property", dt)
        return Response("property", self.store.version,
                        {"name": name, "value": value}, dt)

    def run(self, requests: Sequence[Request]) -> List[Response]:
        responses: List[Optional[Response]] = [None] * len(requests)
        i = 0
        while i < len(requests):
            r = requests[i]
            j = i + 1
            t0 = time.perf_counter()
            if isinstance(r, UpdateBatch):
                while (self.coalesce and j < len(requests)
                       and isinstance(requests[j], UpdateBatch)):
                    j += 1
                responses[i:j] = self._run_updates(list(requests[i:j]))
            elif isinstance(r, MembershipQuery):
                while (self.batch_membership and j < len(requests)
                       and isinstance(requests[j], MembershipQuery)):
                    j += 1
                with obs.span("pipeline.member", merged=j - i):
                    payloads = self._run_membership(list(requests[i:j]))
                dt = time.perf_counter() - t0
                self._observe("member", dt, j - i)
                for k, p in zip(range(i, j), payloads):
                    responses[k] = Response("member", self.store.version,
                                            p, dt)
            elif isinstance(r, NeighborsQuery):
                with obs.span("pipeline.neighbors"):
                    ef = self.store.neighbors(r.vertices,
                                              out_capacity=r.out_capacity)
                n = int(ef.size)
                payload = {"src": ef.src[:n].cpu().numpy(),
                           "dst": ef.dst[:n].cpu().numpy(),
                           "count": n, "overflow": bool(ef.overflow)}
                dt = time.perf_counter() - t0
                self._observe("neighbors", dt)
                responses[i] = Response("neighbors", self.store.version,
                                        payload, dt)
            elif isinstance(r, PropertyRead):
                responses[i] = self._read_property(r.name)
            else:
                obs.inc("pipeline.errors.unknown_request")
                responses[i] = Response(
                    "error", self.store.version,
                    {"error": "unknown_request",
                     "detail": f"unsupported request type "
                               f"{type(r).__name__}",
                     "request": type(r).__name__}, 0.0)
            i = j
        return responses
