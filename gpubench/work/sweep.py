"""Needed bytes of the semiring sweep (``slab_sweep``, kernel 3 in
``csrc/slab_sweep.cu``): PageRank's sums and the BFS and WCC fixpoints.

Each live lane of the allocated rows is read once (its key, 4 B).  Each
distinct key's frontier flag (1 B) is read once where a frontier is given,
and each distinct key's value (the values' width) once where it passes:
every key without a frontier, and with one only the keys in the frontier;
a weighted sweep reads the weight (4 B) of each lane that passes.  Each
allocated row's partial is written (4 B), and an ``arg_min_plus`` row's
target read (4 B).  What a kernel rereads (a value gathered by many
lanes), lanes that hold tombstones or nothing, and rows of spare capacity
are not counted, so the count is the least traffic the call needs.
"""
import torch

HOOKS = {("repro_torch.kernels.slab_sweep.ops", "slab_sweep"):
         "sweep_bytes"}
KERNELS = (r"\bsweep_kernel\b",)


def sweep_bytes(result, keys, slab_vertex, values, weights=None,
                frontier=None, target=None, *, semiring, n_vertices):
    valid = (keys >= 0) & (keys < n_vertices)
    live = valid.sum()
    # every live key marks its vertex once; other lanes mark a spare slot
    at = torch.where(valid, keys, n_vertices)
    seen = torch.zeros(n_vertices + 1, dtype=torch.bool, device=keys.device)
    seen[at] = True
    flags = 0
    if frontier is None:
        passing, lanes = seen[:n_vertices], live
    else:
        flags = seen[:n_vertices].sum()
        front = torch.zeros_like(seen)
        front[:n_vertices] = frontier[:n_vertices] != 0
        passing = seen & front
        lanes = front[at].sum() if weights is not None else 0
    rows = (slab_vertex[:keys.shape[0]] >= 0).sum()
    per_row = 4 + (4 if semiring == "arg_min_plus" else 0)
    return (4 * live + flags + values.element_size() * passing.sum()
            + (4 * lanes if weights is not None else 0) + per_row * rows)
