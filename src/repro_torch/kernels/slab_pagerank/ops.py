"""The slab_pagerank pool sweep in the algorithm layer's (keys, valid,
contrib) convention, from ``repro.kernels.slab_pagerank.ops``."""
from __future__ import annotations

import torch

from .kernel import slab_contrib_sums_cuda
from .ref import slab_contrib_sums_ref


def slab_contrib_sums(keys: torch.Tensor, valid: torch.Tensor,
                      contrib: torch.Tensor) -> torch.Tensor:
    """(S, 128) keys + (S, 128) valid mask + (V,) contrib -> (S,) partials.

    The kernel re-derives the lane mask from the keys; a row counts as
    allocated iff any lane of ``valid`` is set, matching the algorithm
    layer's ``PoolView``.  One launch on CUDA tensors, the plain version on
    CPU tensors.
    """
    # a row's 128 flags read as 16 int64 words: the same test, an eighth of
    # the elements to reduce
    rows = valid.to(torch.bool).contiguous().view(torch.int64)
    owner = rows.any(dim=1).to(torch.int32) - 1
    return slab_contrib_sums_cuda(keys, owner, contrib,
                                  n_vertices=contrib.shape[0])


__all__ = ["slab_contrib_sums", "slab_contrib_sums_cuda",
           "slab_contrib_sums_ref"]
