"""Property kind ``bfs``: the program's BFS-tree stream property from one
source, and its check against the plain reference.

The source is picked as GAP's ``SourcePicker`` picks one: uniform vertex
ids drawn from ``source_seed`` until one has an out-edge in the initial
graph.  ``bfs_level_wrong`` counts served levels that differ from the
reference's; ``bfs_parent_wrong`` served parents that are not an
in-neighbour one level up.
"""
import torch

from gpubench.reference.bfs import bfs_errors

NUMBERS = {"bfs_level_wrong": 0, "bfs_parent_wrong": 0}


def resolve(p, ctx):
    """``p`` with its source vertex."""
    V, keys = ctx.V, ctx.initial
    gen = torch.Generator().manual_seed(int(p["source_seed"]))
    while True:
        c = int(torch.randint(0, V, (1,), generator=gen))
        lo, hi = torch.searchsorted(keys, torch.tensor([c * V, (c + 1) * V]))
        if hi > lo:
            return {**p, "source": c}


def spec(p, ctx):
    from repro_torch.algorithms import bfs_stream_property
    # the frontier holds the initial edges and two batches' inserts
    return bfs_stream_property(
        p["source"], edge_capacity=ctx.initial.numel() + 2 * ctx.batch + 4096)


def check(p, keys, V, value, out):
    dist, parent = value
    lv, pa = bfs_errors(keys, V, p["source"], dist, parent,
                        p["unreached_at"])
    out["bfs_level_wrong"] += lv
    out["bfs_parent_wrong"] += pa
