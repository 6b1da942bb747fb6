"""Intersection-count and membership-probe kernels of the triangle plane,
with their plain PyTorch versions.

``slab_count`` takes (edge, bucket) work items and, per item, walks v's
slab chain in G2 and hash-probes every valid lane w into u's bucket chain
in G1, counting the hits (the kernel reads each row of the packed pools up
to its first EMPTY lane); ``probe_hits`` says whether any lane of a query's
candidate rows equals its key.  On CUDA tensors both launch the
hand-written kernels of ``csrc/slab_intersect.cu``; on CPU tensors they run
the plain versions below, which the CPU tests hold to the reference.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.hashing import (INVALID_SLAB, SLAB_WIDTH, bucket_hash,
                             is_valid_vertex)
from ..slab_update.kernel import slab_probe_torch
from .. import runtime
from .ref import probe_hits_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

#: candidates the plain count probes per gather: a (n, 128) int32 slab
#: gather is 512 bytes a candidate
_PROBE_PIECE = 1 << 20


def _lib() -> ctypes.CDLL:
    lib = runtime.library("slab_intersect")
    if lib.slab_count.argtypes is None:
        lib.slab_count.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.slab_count.restype = _I
        lib.probe_hits.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.probe_hits.restype = _I
        lib.slab_intersect_error_string.argtypes = [_I]
        lib.slab_intersect_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------------------
# intersection count
# ----------------------------------------------------------------------------

def slab_count_torch(g1_keys: torch.Tensor, g1_next: torch.Tensor,
                     g1_boff: torch.Tensor, g1_bcnt: torch.Tensor,
                     g2_keys: torch.Tensor, g2_next: torch.Tensor,
                     start: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Plain version of the count: the active items walk their G2 chains in
    lock step, one gathered slab row per item per hop, and every valid lane
    is probed into G1 with the plain chain-walk probe.  One host sync per
    hop of either walk."""
    out = torch.zeros(start.shape[0], dtype=torch.int32, device=start.device)
    item = torch.nonzero(start != INVALID_SLAB).squeeze(1)
    cur = start[item].long()
    u = us[item].long()
    boff, bcnt = g1_boff[u], g1_bcnt[u]
    while item.numel():
        rows = g2_keys[cur]
        it, lane = torch.nonzero(is_valid_vertex(rows) & (bcnt > 0)[:, None],
                                 as_tuple=True)
        w = rows[it, lane]
        for c0 in range(0, w.numel(), _PROBE_PIECE):
            i, wi = it[c0:c0 + _PROBE_PIECE], w[c0:c0 + _PROBE_PIECE]
            head = (boff[i] + bucket_hash(wi, bcnt[i])).to(torch.int32)
            found = slab_probe_torch(g1_keys, g1_next, head, wi)[0]
            out.index_add_(0, item[i], found.to(torch.int32))
        nxt = g2_next[cur]
        keep = nxt != INVALID_SLAB
        item, cur = item[keep], nxt[keep].long()
        boff, bcnt = boff[keep], bcnt[keep]
    return out


def slab_count(g1_keys: torch.Tensor, g1_next: torch.Tensor,
               g1_boff: torch.Tensor, g1_bcnt: torch.Tensor,
               g2_keys: torch.Tensor, g2_next: torch.Tensor,
               start: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Per work item, |N_G1(u) ∩ slab chain of ``start`` in G2|: (B,) int32.

    G1 is ``g1_keys`` (S1, 128) int32, ``g1_next`` (S1,), ``g1_boff``
    (V+1,) and ``g1_bcnt`` (V,) int32; G2 is ``g2_keys`` (S2, 128) and
    ``g2_next`` (S2,).  ``start`` (B,) int32 holds each item's head slab in
    G2 (-1 = inactive item) and ``us`` (B,) int32 its u, a vertex of G1
    wherever ``start`` is not -1.

    The kernel reads a row only up to its first EMPTY lane, so both pools
    must be packed, as every engine path keeps them: in each row, every
    lane after the first EMPTY lane is EMPTY.  An empty item list launches
    nothing.
    """
    if not g1_keys.is_cuda:
        return slab_count_torch(g1_keys, g1_next, g1_boff, g1_bcnt, g2_keys,
                                g2_next, start, us)
    dev = g1_keys.device
    S1, S2, V, B = (g1_keys.shape[0], g2_keys.shape[0], g1_bcnt.shape[0],
                    start.shape[0])
    runtime.require(g1_keys, "g1_keys", torch.int32, dev, (S1, SLAB_WIDTH),
                    16)
    runtime.require(g1_next, "g1_next", torch.int32, dev, (S1,))
    runtime.require(g1_boff, "g1_boff", torch.int32, dev, (V + 1,))
    runtime.require(g1_bcnt, "g1_bcnt", torch.int32, dev, (V,))
    runtime.require(g2_keys, "g2_keys", torch.int32, dev, (S2, SLAB_WIDTH),
                    16)
    runtime.require(g2_next, "g2_next", torch.int32, dev, (S2,))
    runtime.require(start, "start", torch.int32, dev, (B,))
    runtime.require(us, "us", torch.int32, dev, (B,))
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = _lib()
    rc = lib.slab_count(g1_keys.data_ptr(), g1_next.data_ptr(),
                        g1_boff.data_ptr(), g1_bcnt.data_ptr(),
                        g2_keys.data_ptr(), g2_next.data_ptr(),
                        start.data_ptr(), us.data_ptr(), out.data_ptr(),
                        S1, V, S2, B, runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_intersect_error_string",
                         "slab_count")
    runtime.LAUNCHES["slab_count"] += 1
    return out


# ----------------------------------------------------------------------------
# membership probe over candidate rows
# ----------------------------------------------------------------------------

#: plain version of the probe: the oracle, which gathers every candidate
#: row and compares
probe_hits_torch = probe_hits_ref


def probe_hits(ws: torch.Tensor, cand_rows: torch.Tensor,
               keys: torch.Tensor) -> torch.Tensor:
    """Whether any lane of each query's candidate rows equals its key.

    ``ws`` (Q,) int32 keys, ``cand_rows`` (Q, C) int32 rows of ``keys``
    (S, 128) int32, each -1 (skipped) or a row of the pool -> (Q,) bool.
    """
    if not keys.is_cuda:
        return probe_hits_torch(ws, cand_rows, keys)
    dev = keys.device
    (Q, C), S = cand_rows.shape, keys.shape[0]
    runtime.require(ws, "ws", torch.int32, dev, (Q,))
    runtime.require(cand_rows, "cand_rows", torch.int32, dev, (Q, C))
    runtime.require(keys, "keys", torch.int32, dev, (S, SLAB_WIDTH), 16)
    out = torch.empty(Q, dtype=torch.bool, device=dev)
    lib = _lib()
    rc = lib.probe_hits(ws.data_ptr(), cand_rows.data_ptr(), keys.data_ptr(),
                        out.data_ptr(), Q, C, S, runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_intersect_error_string",
                         "probe_hits")
    runtime.LAUNCHES["probe_hits"] += 1
    return out
