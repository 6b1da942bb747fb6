"""The work list of kernel 10's backward dK/dV pass, built on the host.

The pass owns one key tile of one (b, KV head) a block.  Its work is the
tile's *units*: the (query head of the KV head's group, query tile) pairs
whose tiles hold a visible (query, key) pair, head-major.  Under a causal
mask the first key tile of a sequence has every query tile of the band and
the last one a single tile, so a grid of one block a key tile is neither
full (gemma-2b's MQA shape has 64 key tiles of 64 keys a sequence for 132
SMs) nor balanced.  ``bwd_work_list`` cuts each tile's units into *items*
of near-equal length and orders them longest first, so that the card's
block scheduler, which hands the blocks out in order as SMs free up,
keeps every SM busy to the end (longest processing time first).

The item length is chosen from the shape and the SM count alone: of the
lengths that split the total work into 1 to 8 waves of the card, the one
whose list the same longest-first rule finishes soonest, counting
``ITEM_COST`` units for an item's own loads and stores.  A tile held by one
item writes dK and dV itself; the items of a tile held by several write
float32 partials, a workspace slot each, which the reduction sums in the
list's order, so two launches give the same bits.

The kernel reads the list as it is given: the band of each key tile is
computed here, exactly (a query tile is in the band when one of its rows
sees one of the tile's keys), and the CPU tests hold it to the dense mask
of ``attention_ref``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

#: an item's 8 int32, as ``flash_attention_bwd.cu``'s ``Item`` reads them
ITEM_FIELDS = ("bh", "kt", "u0", "u1", "qt0", "n_band", "slot", "pad")
#: an item's own cost in units: its K and V tiles loaded, its dK and dV
#: written (in float32 for a partial), about two units' bytes
ITEM_COST = 2
#: the most waves of the card the item length is chosen over
MAX_WAVES = 8


@dataclass(frozen=True)
class WorkList:
    """``items`` (n, 8) int32 in launch order (``ITEM_FIELDS``); the
    reduction: ``red_tiles`` (the tiles b * Hkv * n_kt + hk * n_kt + kt
    that are not one item's), ``red_ptr`` (len(red_tiles) + 1) into
    ``red_slots`` (their items' slots, in list order); ``n_slots`` the
    workspace's slots; ``n_kt`` key tiles a (b, KV head)."""
    items: np.ndarray
    red_tiles: np.ndarray
    red_ptr: np.ndarray
    red_slots: np.ndarray
    n_slots: int
    n_kt: int

    def units(self) -> np.ndarray:
        """Units of each item."""
        return self.items[:, 3] - self.items[:, 2]


def band(kt: int, *, key_tile: int, query_tile: int, Sq: int,
         causal: bool, window: int, kv_len: int) -> Tuple[int, int]:
    """Query tiles [qt0, qt1) that hold a row seeing some key of key tile
    ``kt`` (empty when qt1 <= qt0): the tile's keys [k0, k1) stop at
    kv_len; a row i sees key j when i >= j (causal) and i - j < window."""
    k0 = kt * key_tile
    k1 = min(k0 + key_tile, kv_len)
    if k1 <= k0:
        return 0, 0
    q_lo = k0 if causal else 0
    q_hi = Sq if window <= 0 else min(Sq, k1 - 1 + window)
    if q_hi <= q_lo:
        return 0, 0
    return q_lo // query_tile, -(-q_hi // query_tile)


def _split(n: int, parts: int) -> List[int]:
    """n units in ``parts`` runs whose lengths differ by at most one."""
    base, extra = divmod(n, parts)
    return [base + 1] * extra + [base] * (parts - extra)


def _makespan(lengths: List[int], n_sm: int) -> int:
    """When the last SM finishes when blocks of these lengths (plus
    ITEM_COST each) are handed, in order, to whichever SM is free first."""
    free = [0] * min(n_sm, len(lengths))
    heapq.heapify(free)
    for n in lengths:
        heapq.heappush(free, heapq.heappop(free) + n + ITEM_COST)
    return max(free, default=0)


def bwd_work_list(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, *,
                  causal: bool, window: int, kv_len: int, key_tile: int,
                  query_tile: int, n_sm: int) -> WorkList:
    """The dK/dV pass's work list and reduction for one shape (q (B, Hq,
    Sq, D) against k, v (B, Hkv, Skv, D)) on a card of ``n_sm`` SMs."""
    group = Hq // Hkv
    kv_len = min(kv_len, Skv)
    n_kt = -(-Skv // key_tile)
    tiles = []          # (bh, kt, qt0, n_band, units)
    for kt in range(n_kt):
        qt0, qt1 = band(kt, key_tile=key_tile, query_tile=query_tile,
                        Sq=Sq, causal=causal, window=window, kv_len=kv_len)
        if qt1 > qt0:
            for bh in range(B * Hkv):
                tiles.append((bh, kt, qt0, qt1 - qt0, group * (qt1 - qt0)))
    total = sum(t[4] for t in tiles)
    best = None
    for waves in range(1, MAX_WAVES + 1):
        cap = max(1, math.ceil(total / (n_sm * waves)))
        lengths = sorted((n for t in tiles
                          for n in _split(t[4], math.ceil(t[4] / cap))),
                         reverse=True)
        span = _makespan(lengths, n_sm)
        if best is None or span < best[0]:
            best = (span, cap)
    cap = best[1] if best else 1
    rows = []           # (-units, tile index, part, bh, kt, u0, u1, ...)
    for ti, (bh, kt, qt0, nb, n) in enumerate(tiles):
        u0 = 0
        for part, length in enumerate(_split(n, math.ceil(n / cap))):
            rows.append((-length, ti, part, bh, kt, u0, u0 + length, qt0, nb))
            u0 += length
    rows.sort()
    parts = np.bincount([r[1] for r in rows], minlength=len(tiles))
    items = np.zeros((len(rows), len(ITEM_FIELDS)), dtype=np.int32)
    slots: dict = {}
    n_slots = 0
    for i, (_, ti, _, bh, kt, u0, u1, qt0, nb) in enumerate(rows):
        slot = -1
        if parts[ti] > 1:
            slot = n_slots
            n_slots += 1
            slots.setdefault(bh * n_kt + kt, []).append(slot)
        items[i, :7] = (bh, kt, u0, u1, qt0, nb, slot)
    # every tile no item writes alone: the shared ones and the empty ones
    # (written as zeros)
    single = {bh * n_kt + kt for (bh, kt, *_), n in zip(tiles, parts)
              if n == 1}
    red_tiles = [t for t in range(B * Hkv * n_kt) if t not in single]
    red_ptr = np.zeros(len(red_tiles) + 1, dtype=np.int32)
    red_slots = []
    for i, t in enumerate(red_tiles):
        red_slots += slots.get(t, [])
        red_ptr[i + 1] = len(red_slots)
    return WorkList(items=items,
                    red_tiles=np.asarray(red_tiles, dtype=np.int32),
                    red_ptr=red_ptr,
                    red_slots=np.asarray(red_slots, dtype=np.int32),
                    n_slots=n_slots, n_kt=n_kt)
