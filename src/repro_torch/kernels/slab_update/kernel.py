"""Probe and commit kernels of the slab-update engine, with their plain
PyTorch versions.

``slab_probe`` walks each query's slab chain from its head slab and returns
the first (slab, lane) holding the key; ``slab_commit`` scatters planned key
values (dst on insert, TOMBSTONE on delete), weight lanes and degree deltas
into the pool in place.  On CUDA tensors both launch the hand-written
kernels of ``csrc/slab_update.cu``; on CPU tensors they run the plain
versions below, which the CPU tests hold to the reference.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core.hashing import SLAB_WIDTH
from .. import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = runtime.library("slab_update")
    if lib.slab_probe.argtypes is None:
        lib.slab_probe.argtypes = [_P] * 7 + [_I, _I, _P]
        lib.slab_probe.restype = _I
        lib.slab_commit.argtypes = [_P] * 9 + [_I, _I, _I, _P]
        lib.slab_commit.restype = _I
        lib.slab_update_error_string.argtypes = [_I]
        lib.slab_update_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------------------
# probe
# ----------------------------------------------------------------------------

def slab_probe_torch(keys: torch.Tensor, next_slab: torch.Tensor,
                     start: torch.Tensor, dst: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the probe: the whole batch walks in lock step, one
    gathered slab row per query per hop, until every chain ends or hits."""
    B = start.shape[0]
    cur = start.clone()
    found = torch.zeros(B, dtype=torch.bool, device=start.device)
    slab = torch.full_like(start, -1)
    lane = torch.full_like(start, -1)
    while True:
        walking = cur != -1
        if not bool(walking.any()):
            break
        c = cur.clamp_min(0).long()
        hit = (keys[c] == dst[:, None]) & walking[:, None]
        hit_any = hit.any(dim=1)
        hit_lane = hit.to(torch.uint8).argmax(dim=1).to(torch.int32)
        newly = hit_any & ~found
        slab = torch.where(newly, cur, slab)
        lane = torch.where(newly, hit_lane, lane)
        found = found | hit_any
        cur = torch.where(~walking | found, torch.full_like(cur, -1),
                          next_slab[c])
    return found, slab, lane


def slab_probe(keys: torch.Tensor, next_slab: torch.Tensor,
               start: torch.Tensor, dst: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chain-walk probe: (B,) head slabs (-1 = inactive) and keys to find
    -> (found bool, slab int32, lane int32), -1 where absent.

    ``keys`` (S, 128) int32, ``next_slab`` (S,) int32, ``start`` and ``dst``
    (B,) int32; every ``start`` is -1 or a row of the pool.  The kernel
    reads a chain's consecutive rows a run at a time and ends a walk at a
    row outside the pool or after S rows (a corrupt chain); the plain
    version needs every chain to end in -1.
    """
    if not keys.is_cuda:
        return slab_probe_torch(keys, next_slab, start, dst)
    dev = keys.device
    S, B = keys.shape[0], start.shape[0]
    runtime.require(keys, "keys", torch.int32, dev, (S, SLAB_WIDTH), 16)
    runtime.require(next_slab, "next_slab", torch.int32, dev, (S,))
    runtime.require(start, "start", torch.int32, dev, (B,))
    runtime.require(dst, "dst", torch.int32, dev, (B,))
    found = torch.empty(B, dtype=torch.bool, device=dev)
    slab = torch.empty(B, dtype=torch.int32, device=dev)
    lane = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.slab_probe(keys.data_ptr(), next_slab.data_ptr(),
                        start.data_ptr(), dst.data_ptr(), found.data_ptr(),
                        slab.data_ptr(), lane.data_ptr(), S, B,
                        runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_update_error_string", "slab_probe")
    runtime.LAUNCHES["slab_probe"] += 1
    return found, slab, lane


# ----------------------------------------------------------------------------
# commit
# ----------------------------------------------------------------------------

def slab_commit_torch(keys: torch.Tensor, degree: torch.Tensor,
                      weights: Optional[torch.Tensor], e_slab: torch.Tensor,
                      e_lane: torch.Tensor, vals: torch.Tensor,
                      deg_idx: torch.Tensor, deg_delta: torch.Tensor,
                      wvals: Optional[torch.Tensor] = None) -> None:
    """Plain version of the commit.  Raises if two live lanes target the
    same (slab, lane): the engine's plan never does, and the kernel relies
    on it."""
    S, V = keys.shape[0], degree.shape[0]
    ok = (e_slab >= 0) & (e_slab < S)
    at = e_slab[ok].long() * SLAB_WIDTH + e_lane[ok].long()
    if torch.unique(at).numel() != at.numel():
        raise ValueError("slab_commit: two lanes target the same slot")
    keys.view(-1)[at] = vals[ok]
    if weights is not None:
        weights.view(-1)[at] = (torch.zeros_like(at, dtype=torch.float32)
                                if wvals is None else wvals[ok])
    dok = (deg_idx >= 0) & (deg_idx < V)
    degree.index_add_(0, deg_idx[dok].long(), deg_delta[dok])


def slab_commit(keys: torch.Tensor, degree: torch.Tensor,
                weights: Optional[torch.Tensor], e_slab: torch.Tensor,
                e_lane: torch.Tensor, vals: torch.Tensor,
                deg_idx: torch.Tensor, deg_delta: torch.Tensor,
                wvals: Optional[torch.Tensor] = None) -> None:
    """In place: ``keys[slab, lane] = val`` (and the weight lane) where
    ``0 <= slab < S``, ``degree[idx] += delta`` where ``0 <= idx < V``.

    ``keys`` (S, 128) int32, ``degree`` (V,) int32, ``weights`` (S, 128)
    float32 or None; the (B,) plan: ``e_slab``, ``e_lane``, ``vals``,
    ``deg_idx``, ``deg_delta`` int32 and ``wvals`` float32 or None (zeros).
    Live (slab, lane) targets must be distinct.
    """
    if not keys.is_cuda:
        return slab_commit_torch(keys, degree, weights, e_slab, e_lane, vals,
                                 deg_idx, deg_delta, wvals)
    dev = keys.device
    S, V, B = keys.shape[0], degree.shape[0], e_slab.shape[0]
    runtime.require(keys, "keys", torch.int32, dev, (S, SLAB_WIDTH))
    runtime.require(degree, "degree", torch.int32, dev, (V,))
    if weights is not None:
        runtime.require(weights, "weights", torch.float32, dev,
                        (S, SLAB_WIDTH))
    for name, t in (("e_slab", e_slab), ("e_lane", e_lane), ("vals", vals),
                    ("deg_idx", deg_idx), ("deg_delta", deg_delta)):
        runtime.require(t, name, torch.int32, dev, (B,))
    if wvals is not None:
        runtime.require(wvals, "wvals", torch.float32, dev, (B,))
    lib = _lib()
    rc = lib.slab_commit(keys.data_ptr(), degree.data_ptr(),
                         runtime.ptr(weights), e_slab.data_ptr(),
                         e_lane.data_ptr(), vals.data_ptr(),
                         deg_idx.data_ptr(), deg_delta.data_ptr(),
                         runtime.ptr(wvals), S, V, B,
                         runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_update_error_string", "slab_commit")
    runtime.LAUNCHES["slab_commit"] += 1
