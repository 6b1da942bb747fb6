"""Hashing and sentinel constants for the slab pool, in the int32 key encoding.

The reference keeps pool keys as uint32 with the sentinels at the top of the
range.  This package keeps the same 32-bit words as int32 bit patterns, since
``torch.uint32`` lacks comparisons, shifts, ``%`` and ``index_put_`` on the
CPU.  The CUDA kernels read the very same words as ``uint32_t``, so a pool
here and a pool of the reference compare word for word.

  ====================  ==============  ===========
  name                  uint32          int32
  ====================  ==============  ===========
  ``EMPTY_KEY``         ``0xFFFFFFFE``  ``-2``
  ``TOMBSTONE_KEY``     ``0xFFFFFFFD``  ``-3``
  ``INVALID_VERTEX``    ``0xFFFFFFFF``  ``-1``
  ====================  ==============  ===========

Every non-sentinel key is a neighbour id, so "key is a live vertex of a graph
with ``n`` vertices" reads ``0 <= key < n`` (an id at or above ``2**31`` is
negative here and fails the test, as it fails ``key < n`` in uint32).
"""
from __future__ import annotations

import numpy as np
import torch

SLAB_WIDTH = 128

EMPTY_KEY = -2
TOMBSTONE_KEY = -3
INVALID_VERTEX = -1
INVALID_SLAB = -1
INVALID_LANE = -1

_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF


def as_key_bits(a) -> np.ndarray:
    """Any host id array (uint32 values, or int32 bit patterns) as int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.int32:
        return a
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.astype(np.int64).astype(np.uint32).view(np.int32)


def bucket_hash(dst: torch.Tensor, n_buckets: torch.Tensor) -> torch.Tensor:
    """Bucket of each destination id within its source's table.

    ``((dst * 2654435761) mod 2**32 >> 8) % n_buckets``, bit for bit as the
    reference computes it in uint32.  ``dst`` holds int32 bit patterns; the
    product is formed from two 16-bit halves of the multiplier so that no
    intermediate leaves the int64 range.
    """
    d = dst.to(torch.int64) & _MASK32
    lo = d * (_KNUTH & 0xFFFF)
    hi = ((d * (_KNUTH >> 16)) & 0xFFFF) << 16
    h = ((lo + hi) & _MASK32) >> 8
    return (h % n_buckets.to(torch.int64)).to(torch.int32)


def is_valid_vertex(v: torch.Tensor) -> torch.Tensor:
    """Lane holds a real neighbour id (no EMPTY/TOMBSTONE/INVALID sentinel)."""
    return (v != EMPTY_KEY) & (v != TOMBSTONE_KEY) & (v != INVALID_VERTEX)
