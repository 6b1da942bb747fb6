"""Live-census and chain-rank kernels of slab compaction, with their plain
PyTorch versions.

``slab_live`` counts each row's live lanes and gives every lane its
exclusive rank among the row's live lanes; ``chain_rank`` walks every
bucket chain from its head and gives each reached slab its base rank,
bucket and chain position, and each bucket its survivor total.  On CUDA
tensors both launch the hand-written kernels of ``csrc/slab_compact.cu``;
on CPU tensors they run the plain versions below, which the CPU tests hold
to the reference.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core.hashing import SLAB_WIDTH
from .. import runtime
from .ref import chain_order, live_lane_mask

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = runtime.library("slab_compact")
    if lib.slab_live.argtypes is None:
        lib.slab_live.argtypes = [_P] * 4 + [_I, _P]
        lib.slab_live.restype = _I
        lib.slab_chain_rank.argtypes = [_P] * 7 + [_I, _I, _P]
        lib.slab_chain_rank.restype = _I
        lib.slab_compact_error_string.argtypes = [_I]
        lib.slab_compact_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------------------
# live census
# ----------------------------------------------------------------------------

def slab_live_torch(keys: torch.Tensor, slab_vertex: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the census: a masked cumulative sum per row."""
    li = live_lane_mask(keys, slab_vertex).to(torch.int32)
    rank = torch.cumsum(li, dim=1, dtype=torch.int32) - li
    return li.sum(dim=1, dtype=torch.int32), rank


def slab_live(keys: torch.Tensor, slab_vertex: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, 128) keys and (S,) owners -> ((S,) live counts, (S, 128)
    exclusive lane ranks among live lanes), int32.

    A lane is live when its row's owner is >= 0 and its key, read as
    uint32, is below TOMBSTONE.
    """
    if not keys.is_cuda:
        return slab_live_torch(keys, slab_vertex)
    dev = keys.device
    S = keys.shape[0]
    runtime.require(keys, "keys", torch.int32, dev, (S, SLAB_WIDTH), 16)
    runtime.require(slab_vertex, "slab_vertex", torch.int32, dev, (S,))
    cnt = torch.empty(S, dtype=torch.int32, device=dev)
    rank = torch.empty((S, SLAB_WIDTH), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.slab_live(keys.data_ptr(), slab_vertex.data_ptr(),
                       cnt.data_ptr(), rank.data_ptr(), S,
                       runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_compact_error_string", "slab_live")
    runtime.LAUNCHES["slab_live"] += 1
    return cnt, rank


# ----------------------------------------------------------------------------
# chain rank
# ----------------------------------------------------------------------------

def chain_rank_torch(next_slab: torch.Tensor, live_count: torch.Tensor,
                     n_buckets: int):
    """Plain version of the chain walk: ``ref.chain_order``."""
    return chain_order(next_slab, live_count, n_buckets)


def chain_rank(next_slab: torch.Tensor, live_count: torch.Tensor,
               n_buckets: int):
    """Walk the chain of every bucket ``b`` from its head row ``b``.

    ``next_slab`` and ``live_count`` (S,) int32.  Returns ``(base_rank,
    bucket_of, chain_pos)``, (S,) int32 (0, -1, -1 for rows no chain
    reaches), and ``counts``, (n_buckets,) int32.  Chains must be disjoint
    and end in -1 (the kernel ends a walk at a row outside the pool or
    after S rows, the plain version only at -1).
    """
    if not next_slab.is_cuda:
        return chain_rank_torch(next_slab, live_count, n_buckets)
    dev = next_slab.device
    S = next_slab.shape[0]
    if not 0 <= n_buckets <= S:
        raise ValueError(f"n_buckets={n_buckets} outside the {S} rows")
    runtime.require(next_slab, "next_slab", torch.int32, dev, (S,))
    runtime.require(live_count, "live_count", torch.int32, dev, (S,))
    base_rank = torch.empty(S, dtype=torch.int32, device=dev)
    bucket_of = torch.empty(S, dtype=torch.int32, device=dev)
    chain_pos = torch.empty(S, dtype=torch.int32, device=dev)
    counts = torch.empty(n_buckets, dtype=torch.int32, device=dev)
    # the kernel's queue of long chains: (bucket, row, rank, position) per
    # entry, then the count of entries
    queue = torch.empty(4 * n_buckets + 1, dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.slab_chain_rank(next_slab.data_ptr(), live_count.data_ptr(),
                             base_rank.data_ptr(), bucket_of.data_ptr(),
                             chain_pos.data_ptr(), counts.data_ptr(),
                             queue.data_ptr(), S, n_buckets,
                             runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_compact_error_string",
                         "slab_chain_rank")
    runtime.LAUNCHES["slab_chain_rank"] += 1
    return base_rank, bucket_of, chain_pos, counts
