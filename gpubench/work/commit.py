"""Needed bytes of the commit (``slab_commit``, kernel 2 in
``csrc/slab_update.cu``): the update engine's planned writes.

Each plan entry is read (slab, lane, value, degree index and delta: 20 B,
and its weight where one is given); each entry that targets a row of the
pool writes its key lane (and its weight lane on a weighted pool); each
distinct vertex with a degree delta has its degree read and written once
(8 B).
"""
import torch

HOOKS = {("repro_torch.kernels.slab_update.ops", "slab_commit"):
         "commit_bytes"}
KERNELS = (r"\bcommit_kernel\b",)


def commit_bytes(result, keys, degree, weights, e_slab, e_lane, vals,
                 deg_idx, deg_delta, wvals=None):
    S, V, B = keys.shape[0], degree.shape[0], e_slab.shape[0]
    plan = (20 + (4 if wvals is not None else 0)) * B
    lanes = ((e_slab >= 0) & (e_slab < S)).sum()
    idx = deg_idx[(deg_idx >= 0) & (deg_idx < V)].long()
    seen = torch.zeros(V, dtype=torch.bool, device=degree.device)
    seen[idx] = True
    degs = seen.sum()
    return plan + (4 + (4 if weights is not None else 0)) * lanes + 8 * degs
