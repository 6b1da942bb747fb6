"""Needed bytes of the chain-walk probe (``slab_probe``, kernel 1 in
``csrc/slab_update.cu``): membership queries and the engine's lookups.

Per query its head row and key are read (8 B) and its found flag, slab
and lane written (9 B).  A query walks its chain from the head row to the
first row that holds its key, or to the chain's end where none does; a
row walked costs its live keys (4 B each) and its link (4 B), once a
call however many queries walk it: a chain counts from its head to the
furthest row any of its queries reaches.  Where a walk stops is the
first hit along the chain, which the call's answer names; the lanes and
rows from a chain's head to any row are found for every row at once by
pointer jumping over the links.
"""
import torch

HOOKS = {("repro_torch.kernels.slab_update.ops", "slab_probe"):
         "probe_bytes"}
KERNELS = (r"\bprobe_kernel\b",)


def ranked(ptr, weight):
    """Along the lists that ``ptr`` links (-1 ends one), for every row the
    sum of ``weight`` and the number of rows from it to its list's end,
    itself included (Wyllie's pointer jumping)."""
    acc, n, p = weight.clone(), torch.ones_like(weight), ptr.clone()
    while True:
        on = torch.nonzero(p >= 0).flatten()
        if on.numel() == 0:
            return acc, n
        q = p[on]
        acc[on] += acc[q]
        n[on] += n[q]
        p[on] = p[q]


def probe_bytes(result, keys, next_slab, start, dst):
    found, slab, _lane = result
    S, B = keys.shape[0], start.numel()
    live = (keys >= 0).sum(1)
    rows = torch.arange(S, device=keys.device)
    nxt = next_slab.long()
    nxt = torch.where((nxt >= 0) & (nxt < S), nxt, -1)
    prev = torch.full((S,), -1, dtype=torch.long, device=keys.device)
    linked = nxt >= 0
    prev[nxt[linked]] = rows[linked]
    to_end, rows_to_end = ranked(nxt, live)      # row .. chain's end
    from_head, rows_from_head = ranked(prev, live)  # chain's head .. row
    head = start.long()
    ok = (head >= 0) & (head < S)
    head = head[ok]
    hit = found.bool()[ok]
    s = slab.long()[ok].clamp(0, S - 1)
    lanes = torch.where(hit, from_head[s] - from_head[head] + live[head],
                        to_end[head])
    walked = torch.where(hit, rows_from_head[s] - rows_from_head[head] + 1,
                         rows_to_end[head])
    # along a chain, lanes grow with rows: the furthest walk holds both
    far_lanes = torch.zeros(S, dtype=lanes.dtype, device=keys.device)
    far_rows = torch.zeros(S, dtype=walked.dtype, device=keys.device)
    far_lanes.scatter_reduce_(0, head, lanes, "amax")
    far_rows.scatter_reduce_(0, head, walked, "amax")
    return 17 * B + 4 * far_lanes.sum() + 4 * far_rows.sum()
