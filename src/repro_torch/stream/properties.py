"""Incremental-property registry: the query plane of the serving loop.

Analytics register ``{init, on_batch, refresh}`` maintainers keyed to store
versions.  ``eager`` entries advance inside every ``GraphStore.apply``
while the epoch is open; ``lazy`` entries catch up on first read by
replaying the store's batch log through ``on_batch`` (once, for a
``collapse_replay`` maintainer), or by ``refresh`` when the bounded log no
longer reaches back far enough.  Maintenance batches (compaction, slab
reclamation) change no edge and no vertex id: an eager entry only
re-anchors its version, and a lazy catch-up skips them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from .store import AppliedBatch, GraphStore

EAGER = "eager"
LAZY = "lazy"


@dataclasses.dataclass(frozen=True)
class PropertySpec:
    """How to build, advance and rebuild one property of a GraphStore.
    ``collapse_replay`` declares ``on_batch`` independent of the batch (it
    reads only the current graph), so catch-up runs it once."""
    name: str
    init: Callable[[GraphStore], Any]
    on_batch: Callable[[GraphStore, Any, AppliedBatch], Any]
    refresh: Callable[[GraphStore], Any]
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

    def register(self, spec: PropertySpec, *, policy: str = LAZY) -> None:
        """Register a maintainer; runs its ``init`` now."""
        if policy not in (EAGER, LAZY):
            raise ValueError(f"unknown policy {policy!r}")
        if spec.name in self._entries:
            raise KeyError(f"property {spec.name!r} already registered")
        self._entries[spec.name] = _Entry(spec, policy, spec.init(self.store),
                                          self.store.version)

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
        if missed is None:
            e.state = e.spec.refresh(self.store)
        elif e.spec.collapse_replay and missed:
            e.state = e.spec.on_batch(self.store, e.state, missed[-1])
        else:
            for batch in missed:
                e.state = e.spec.on_batch(self.store, e.state, batch)
        e.version = self.store.version

    def read(self, name: str) -> Any:
        """The property's state at the store's current version."""
        e = self._entries[name]
        self._catch_up(e)
        return e.state
