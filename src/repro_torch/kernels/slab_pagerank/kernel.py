"""Kernel 4 as a thin binding onto kernel 3 (``csrc/slab_sweep.cu``): gather
``contrib[u]`` at each lane key, mask invalid lanes, sum across lanes.

Kernel 3 reads a row only up to its first EMPTY lane, where the reference
sums every lane, so the two agree only on packed rows (every lane after
the first EMPTY lane EMPTY), which every engine path keeps.  This entry
point refuses a pool with an unpacked row, on either device (one reduction
and one host read), so that the card and the CPU answer alike.
"""
from __future__ import annotations

import torch

from ...core.hashing import EMPTY_KEY
from .. import runtime
from ..slab_sweep.kernel import slab_sweep


def unpacked_rows(keys: torch.Tensor) -> int:
    """Rows of ``keys`` (S, 128) with a non-EMPTY lane after an EMPTY
    lane."""
    empty = keys == EMPTY_KEY
    first = torch.where(empty.any(dim=1), empty.to(torch.uint8).argmax(dim=1),
                        keys.shape[1])
    return int(((~empty).sum(dim=1) != first).sum())


def slab_contrib_sums_cuda(keys: torch.Tensor, slab_vertex: torch.Tensor,
                           contrib: torch.Tensor, *,
                           n_vertices: int) -> torch.Tensor:
    """keys (S, 128) int32, slab_vertex (S,) int32, contrib (V,) float32
    -> (S,) float32 partials: kernel 3's ``sum`` on CUDA tensors, its
    plain version on CPU tensors.  Raises ``ValueError`` on unpacked rows.
    """
    bad = unpacked_rows(keys)
    if bad:
        raise ValueError(f"{bad} slab rows hold a key after an EMPTY lane; "
                         "the sweep reads a row only up to its first EMPTY "
                         "lane and needs packed rows")
    out = slab_sweep(keys, slab_vertex, contrib, semiring="sum",
                     n_vertices=n_vertices)
    if keys.is_cuda:
        runtime.LAUNCHES["slab_contrib_sums"] += 1
    return out
