"""Needed bytes of the contribution sums (``slab_contrib_sums_cuda``,
kernel 4 in ``csrc/slab_pagerank.cu``): PageRank with
``contrib_impl="ref"``.

Each live lane is read once (its key, 4 B), each distinct key's
contribution once (4 B), and each allocated row's sum written (4 B).  The
kernel reads whole rows; the count holds it to the live lanes, as it
holds kernel 3.
"""
import torch

HOOKS = {("repro_torch.algorithms.pagerank", "slab_contrib_sums_cuda"):
         "contrib_bytes"}
KERNELS = (r"\bcontrib_sums_kernel\b",)


def contrib_bytes(result, keys, owner, contrib, *, n_vertices):
    valid = (keys >= 0) & (keys < n_vertices)
    seen = torch.zeros(n_vertices + 1, dtype=torch.bool, device=keys.device)
    seen[torch.where(valid, keys, n_vertices)] = True
    return (4 * valid.sum() + 4 * seen[:n_vertices].sum()
            + 4 * (owner[:keys.shape[0]] >= 0).sum())
