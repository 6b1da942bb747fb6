"""Incremental-property registry: the query plane of the serving loop.

Analytics register ``{init, on_batch, refresh}`` maintainers keyed to store
versions.  ``eager`` entries advance inside every ``GraphStore.apply``
while the epoch is open; ``lazy`` entries catch up on first read by
replaying the store's batch log through ``on_batch`` (once, for a
``collapse_replay`` maintainer), or by ``refresh`` when the bounded log no
longer reaches back far enough.  Maintenance batches (compaction, slab
reclamation) change no edge and no vertex id: an eager entry only
re-anchors its version, and a lazy catch-up skips them.

``state_like(n_vertices)`` builds a cheap skeleton of the state (its
structure and dtypes) so a checkpoint restores without recomputing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs
from .store import AppliedBatch, GraphStore

EAGER = "eager"
LAZY = "lazy"
_UNSET = object()


@dataclasses.dataclass(frozen=True)
class PropertySpec:
    """How to build, advance and rebuild one property of a GraphStore.
    ``collapse_replay`` declares ``on_batch`` independent of the batch (it
    reads only the current graph), so catch-up runs it once."""
    name: str
    init: Callable[[GraphStore], Any]
    on_batch: Callable[[GraphStore, Any, AppliedBatch], Any]
    refresh: Callable[[GraphStore], Any]
    state_like: Optional[Callable[[int], Any]] = None
    collapse_replay: bool = False


@dataclasses.dataclass
class _Entry:
    spec: PropertySpec
    policy: str
    state: Any
    version: int


class PropertyRegistry:
    """Versioned property states over one GraphStore; subscribes to the
    store's applied batches on construction."""

    def __init__(self, store: GraphStore):
        self.store = store
        self._entries: Dict[str, _Entry] = {}
        store.add_listener(self._on_batch)

    def register(self, spec: PropertySpec, *, policy: str = LAZY,
                 _state: Any = _UNSET, _version: Optional[int] = None
                 ) -> None:
        """Register a maintainer; runs its ``init`` now, unless
        ``_state``/``_version`` adopt a restored checkpoint's state (see
        ``GraphStore.restore``)."""
        if policy not in (EAGER, LAZY):
            raise ValueError(f"unknown policy {policy!r}")
        if spec.name in self._entries:
            raise KeyError(f"property {spec.name!r} already registered")
        if _state is _UNSET:
            state, version = spec.init(self.store), self.store.version
        else:
            state, version = _state, int(_version)
        self._entries[spec.name] = _Entry(spec, policy, state, version)

    def names(self) -> List[str]:
        return list(self._entries)

    def states(self) -> Dict[str, Any]:
        """Current states without catch-up (pair with ``versions`` when
        persisting: a lazy state is valid for its recorded version)."""
        return {name: e.state for name, e in self._entries.items()}

    def versions(self) -> Dict[str, int]:
        return {name: e.version for name, e in self._entries.items()}

    def status(self) -> Dict[str, dict]:
        return {name: {"policy": e.policy, "version": e.version,
                       "stale": e.version < self.store.version}
                for name, e in self._entries.items()}

    def _on_batch(self, batch: AppliedBatch) -> None:
        for e in self._entries.values():
            if e.policy != EAGER:
                continue
            if batch.maintenance:
                # the state already holds for the new version
                if e.version == batch.version - 1:
                    e.version = batch.version
                continue
            e.state = e.spec.on_batch(self.store, e.state, batch)
            e.version = batch.version

    def _catch_up(self, e: _Entry) -> None:
        if e.version == self.store.version:
            return
        missed = self.store.batches_since(e.version)
        if missed is not None:
            missed = [b for b in missed if not b.maintenance]
        name = e.spec.name
        if missed is None:
            with obs.span("property.refresh", prop=name):
                e.state = e.spec.refresh(self.store)
            obs.inc(f"property.{name}.refresh")
        elif e.spec.collapse_replay and missed:
            with obs.span("property.replay", prop=name, collapsed=True,
                          depth=len(missed)):
                e.state = e.spec.on_batch(self.store, e.state, missed[-1])
            obs.inc(f"property.{name}.replay_collapsed")
            obs.observe(f"property.replay_depth.{name}", len(missed))
        else:
            with obs.span("property.replay", prop=name, depth=len(missed)):
                for batch in missed:
                    e.state = e.spec.on_batch(self.store, e.state, batch)
            obs.inc(f"property.{name}.replay", max(1, len(missed)))
            obs.observe(f"property.replay_depth.{name}", len(missed))
        e.version = self.store.version

    def read(self, name: str) -> Any:
        """The property's state at the store's current version."""
        e = self._entries[name]
        if obs.metrics.enabled():
            # staleness at read: the epochs this property lags the store
            obs.observe(f"property.staleness.{name}",
                        self.store.version - e.version)
        self._catch_up(e)
        return e.state

    def peek(self, name: str) -> Tuple[Any, int]:
        """``(state, version)`` as it stands: no catch-up, no device work.
        The pipeline serves this while its circuit breaker is open, rather
        than force a replay through a failing store."""
        e = self._entries[name]
        return e.state, e.version

    def refresh(self, name: str) -> Any:
        """Force a static recompute (and re-anchor the version)."""
        e = self._entries[name]
        e.state = e.spec.refresh(self.store)
        e.version = self.store.version
        return e.state
