"""The work list of kernel 10's backward dK/dV pass (``schedule.py``), on
the CPU.

The kernel trusts the list: each item's units name the (query head, query
tile) pairs it adds into its key tile, and the reduction sums the slots it
is given.  So the list must cover every visible (b, query head, query
tile, key tile) exactly once and nothing else, where "visible" is a tile
pair holding a (query, key) pair of ``visibility``, the dense mask
``attention_ref`` applies; every item must hold a unit, every shared tile
must be reduced over exactly its items' slots in the list's order, and
every tile no item writes alone (shared, or seen by no query: zeros) must
be reduced.  Over the card test's ``ATTN_CASES`` kinds (GQA, windows,
``kv_len`` below Skv and 0, Sq != Skv, sizes multiples of no tile), the
backward's edge cases and the trained and served models' shapes, with the
key tiles of both dtypes.  At gemma-2b's training shape the list must fill
an H100's 132 SMs and keep its items within 10% of their mean length.
"""
import numpy as np
import pytest

from repro_torch.kernels.flash_attention.kernel import BWD_KEY_TILES
from repro_torch.kernels.flash_attention.ref import visibility
from repro_torch.kernels.flash_attention.schedule import (ITEM_COST,
                                                          ITEM_FIELDS,
                                                          _makespan,
                                                          bwd_work_list)
from test_torch_gpu import ATTN_CASES, BWD_EDGE_CASES

N_SM = 132
#: (B, Hq, Hkv, Sq, Skv, causal, window, kv_len)
SHAPES = {f"attn{i}": (B, Hq, Hkv, Sq, Skv, causal, window,
                       extra.get("kv_len", Skv))
          for i, (B, Hq, Hkv, Sq, Skv, _, causal, window, _, _, extra)
          in enumerate(ATTN_CASES)}
SHAPES.update({f"edge{i}": (B, Hq, Hkv, Sq, Skv, causal, window,
                            extra.get("kv_len", Skv))
               for i, (B, Hq, Hkv, Sq, Skv, _, causal, window, _, _, extra)
               in enumerate(BWD_EDGE_CASES)})
SHAPES.update({
    # a train_4k microbatch of gemma-2b (MQA 8/1)
    "gemma-2b": (1, 8, 1, 4096, 4096, True, 0, 4096),
    # gemma2-9b's prefill layers (GQA 16/8, a 4,096 window on local ones)
    "gemma2-9b global": (2, 16, 8, 8192, 8192, True, 0, 8192),
    "gemma2-9b local": (2, 16, 8, 8192, 8192, True, 4096, 8192),
    # qwen3-moe-30b-a3b's prefill layers (GQA 32/4)
    "qwen3-moe": (2, 32, 4, 8192, 8192, True, 0, 8192),
    # a cache longer than the queries, a window, kv_len inside a tile
    "window Sq < Skv": (1, 4, 2, 333, 700, False, 90, 650),
})
TILES = sorted(set(BWD_KEY_TILES.values()))


def _list(shape, tile):
    B, Hq, Hkv, Sq, Skv, causal, window, kv_len = shape
    return bwd_work_list(B, Hq, Hkv, Sq, Skv, causal=causal, window=window,
                         kv_len=kv_len, key_tile=tile, query_tile=tile,
                         n_sm=N_SM)


def _visible_tiles(shape, tile):
    """(n_qt, n_kt) bool: the tile pairs holding a visible pair."""
    _, _, _, Sq, Skv, causal, window, kv_len = shape
    mask = visibility(Sq, Skv, causal=causal, window=window,
                      kv_len=kv_len).numpy()
    n_qt, n_kt = -(-Sq // tile), -(-Skv // tile)
    pad = np.zeros((n_qt * tile, n_kt * tile), dtype=bool)
    pad[:Sq, :Skv] = mask
    return pad.reshape(n_qt, tile, n_kt, tile).any(axis=(1, 3))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_items_cover_visible_tiles_once(name, tile):
    shape = SHAPES[name]
    B, Hq, Hkv = shape[:3]
    group = Hq // Hkv
    wl = _list(shape, tile)
    vis = _visible_tiles(shape, tile)
    n_qt, n_kt = vis.shape
    assert wl.n_kt == n_kt
    assert wl.items.shape == (len(wl.items), len(ITEM_FIELDS))
    assert wl.items.dtype == np.int32
    cover = np.zeros((B, Hq, n_qt, n_kt), dtype=np.int64)
    for bh, kt, u0, u1, qt0, nb, _, _ in wl.items:
        assert u1 > u0, "an empty item"
        u = np.arange(u0, u1)
        hh, qt = u // nb, qt0 + u % nb
        assert hh.max() < group and qt.max() < n_qt
        b, hk = divmod(int(bh), Hkv)
        np.add.at(cover, (b, hk * group + hh, qt, kt), 1)
    want = np.broadcast_to(vis, cover.shape).astype(np.int64)
    assert np.array_equal(cover, want)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_reduction_walks_each_tiles_slots_in_list_order(name, tile):
    shape = SHAPES[name]
    B, _, Hkv = shape[:3]
    wl = _list(shape, tile)
    n_tiles = B * Hkv * wl.n_kt
    per_tile = {}
    for i, (bh, kt, *_rest) in enumerate(wl.items):
        per_tile.setdefault(int(bh) * wl.n_kt + int(kt), []).append(i)
    slots = wl.items[:, 6]
    # a slot an item of a shared tile, numbered in list order
    shared = [i for idx in per_tile.values() if len(idx) > 1 for i in idx]
    assert sorted(slots[shared].tolist()) == list(range(wl.n_slots))
    assert np.all(np.diff(slots[slots >= 0]) == 1)
    assert all(slots[idx[0]] == -1 for idx in per_tile.values()
               if len(idx) == 1)
    reduced = wl.red_tiles.tolist()
    assert reduced == sorted(set(reduced))
    assert set(reduced) == set(range(n_tiles)) - {
        t for t, idx in per_tile.items() if len(idx) == 1}
    assert wl.red_ptr[0] == 0 and wl.red_ptr[-1] == len(wl.red_slots)
    for r, t in enumerate(reduced):
        got = wl.red_slots[wl.red_ptr[r]:wl.red_ptr[r + 1]].tolist()
        assert got == [int(slots[i]) for i in per_tile.get(t, [])]


@pytest.mark.parametrize("name", ["gemma-2b", "gemma2-9b local", "edge0"])
def test_list_is_fixed(name):
    """The same shape gives the same list, array for array."""
    a, b = _list(SHAPES[name], 64), _list(SHAPES[name], 64)
    for f in ("items", "red_tiles", "red_ptr", "red_slots"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert a.n_slots == b.n_slots


@pytest.mark.parametrize("tile", TILES)
def test_gemma_2b_fills_the_card_in_balanced_items(tile):
    """At gemma-2b's training shape a block a 32-key tile would make 128
    blocks of 1 to 128 query tiles (8 heads each); the list's items fill
    132 SMs, none is longer than 1.1x the mean, and handed out longest
    first they finish within 15% of an even split of the work (items' own
    cost included)."""
    wl = _list(SHAPES["gemma-2b"], tile)
    units = wl.units()
    assert len(units) >= N_SM
    assert units.max() <= 1.1 * units.mean()
    assert np.all(np.diff(units) <= 0), "not longest first"
    even = (units.sum() + ITEM_COST * len(units)) / N_SM
    assert _makespan(units.tolist(), N_SM) <= 1.15 * even


def test_no_keys_no_items():
    """kv_len 0 and Skv 0: no item; every tile (if any) is reduced, as
    zeros."""
    wl = bwd_work_list(1, 2, 2, 128, 128, causal=True, window=0, kv_len=0,
                       key_tile=64, query_tile=64, n_sm=N_SM)
    assert len(wl.items) == 0 and wl.n_slots == 0
    assert wl.red_tiles.tolist() == list(range(4))
    assert wl.red_ptr.tolist() == [0] * 5
    wl = bwd_work_list(1, 2, 2, 128, 0, causal=True, window=0, kv_len=0,
                       key_tile=64, query_tile=64, n_sm=N_SM)
    assert len(wl.items) == 0 and len(wl.red_tiles) == 0
