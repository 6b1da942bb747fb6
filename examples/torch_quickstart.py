"""Quickstart on the PyTorch port: build a dynamic graph, mutate it, run
incremental analytics (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card (the update engine's probe and commit kernels)
unless given ``--device cpu``, where the plain PyTorch
versions run; without a card ``cuda`` raises.  ``main`` returns the numbers
it prints.
"""
import argparse

import numpy as np
import torch

from repro_torch.algorithms import (bfs_incremental, bfs_tree_static,
                                    wcc_incremental_update_iterator,
                                    wcc_static)
from repro_torch.core import (delete_edges, empty, ensure_capacity,
                              insert_edges, query_edges, resolve_device,
                              update_slab_pointers)


def pad(xs, n, device):
    """uint32 ids padded with INVALID_VERTEX, as the port's int32 keys."""
    a = np.full(n, 0xFFFFFFFF, np.uint32)
    a[:len(xs)] = xs
    return torch.from_numpy(a.view(np.int32)).to(device)


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    out = {}

    # 1. an empty 1000-vertex dynamic graph (one slab list per vertex)
    V = 1000
    g = empty(V, np.ones(V, np.int32), capacity_slabs=2048, device=dev)

    # 2. batched edge insertion (the paper's InsertEdgeBatch)
    rng = np.random.default_rng(0)
    src = rng.integers(0, V, 5000).astype(np.uint32)
    dst = rng.integers(0, V, 5000).astype(np.uint32)
    B = 1024
    for i in range(0, len(src), B):
        g = ensure_capacity(g, B)
        g, inserted = insert_edges(g, pad(src[i:i + B], B, dev),
                                   pad(dst[i:i + B], B, dev))
    out["edges"], out["slabs"] = int(g.n_edges), int(g.next_free)
    print(f"graph has {out['edges']} edges in {out['slabs']} slabs")

    # 3. membership queries
    found = query_edges(g, pad(src[:4], 8, dev), pad(dst[:4], 8, dev))
    out["found"] = found.cpu().numpy()[:4].tolist()
    print("first four inserted edges found:", out["found"])

    # 4. static analytics
    state, iters = bfs_tree_static(g, 0, edge_capacity=8192)
    out["reachable"] = int((state.dist.cpu().numpy() < 1e29).sum())
    out["rounds"] = int(iters)
    print(f"BFS from 0: {out['reachable']} reachable in {out['rounds']} "
          f"rounds")
    labels = wcc_static(g)
    out["components"] = int((labels.cpu().numpy() == np.arange(V)).sum())
    print(f"WCC: {out['components']} components")

    # 5. incremental: insert a batch, repair BFS + WCC without recompute
    g = update_slab_pointers(g)         # open a fresh update epoch
    new_s = rng.integers(0, V, 64).astype(np.uint32)
    new_d = rng.integers(0, V, 64).astype(np.uint32)
    g = ensure_capacity(g, 128)
    g, ins = insert_edges(g, pad(new_s, 64, dev), pad(new_d, 64, dev))
    state, _ = bfs_incremental(g, state, pad(new_s, 64, dev),
                               pad(new_d, 64, dev), ins, edge_capacity=8192)
    labels = wcc_incremental_update_iterator(labels, g, cap=256)
    out["reachable_after"] = int((state.dist.cpu().numpy() < 1e29).sum())
    out["components_after"] = int(
        (labels.cpu().numpy() == np.arange(V)).sum())
    print(f"after batch: {out['reachable_after']} reachable, "
          f"{out['components_after']} components")

    # 6. deletion flips lanes to tombstones
    g, dele = delete_edges(g, pad(new_s[:8], 16, dev),
                           pad(new_d[:8], 16, dev))
    out["deleted"] = int(dele.sum())
    print(f"deleted {out['deleted']} edges")
    print("quickstart OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
