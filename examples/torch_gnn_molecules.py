"""Train NequIP on random molecules whose bond graph lives in a DYNAMIC
SlabGraph (``examples/gnn_molecules.py`` on ``repro_torch``): each step
perturbs the neighbor lists through edge batches (the MD
neighbor-list-rebuild pattern), and the GNN consumes the live topology via
``edges_from_slab``.

    PYTHONPATH=src python examples/torch_gnn_molecules.py [--device cpu]

Runs on the CUDA card (the update engine's probe and commit kernels) unless
given ``--device cpu``, where the plain PyTorch versions run; without a
card ``cuda`` raises.  The weights are drawn on the CPU from a generator
seeded with 0 and moved to the device, so both devices start alike;
``main(params=...)`` takes another initial tree (numpy arrays or tensors,
the reference's keys).  ``main`` returns the numbers it prints.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (delete_edges, empty, ensure_capacity,
                              insert_edges, resolve_device)
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.gnn import nequip
from repro_torch.models.gnn.common import (GraphBatch, edges_from_slab,
                                           params_from_numpy)
from repro_torch.train import optimizer as opt

V, E_CAP = 64, 512
cfg = nequip.NequIPConfig(n_layers=2, channels=8, n_species=5)
adamw = opt.AdamWConfig(lr=1e-3)


def pad(xs, n, device):
    """uint32 ids padded with INVALID_VERTEX, as the port's int32 keys."""
    a = np.full(n, 0xFFFFFFFF, np.uint32)
    a[:len(xs)] = np.asarray(xs, np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def loss_fn(params, batch, targets):
    return nequip.energy_loss(params, batch, targets, cfg)


def step(params, ostate, batch, target):
    loss, grads = value_and_grad(loss_fn, params, batch, target)
    params, ostate = opt.update(adamw, grads, ostate, params)
    return params, ostate, loss


def main(device="cuda", params=None) -> dict:
    dev = resolve_device(device)
    if params is None:
        params = nequip.init_params(cfg, torch.Generator().manual_seed(0))
    params = params_from_numpy(params, dev)
    ostate = opt.init(params)

    # dynamic bond graph
    g = empty(V, np.ones(V, np.int32), 256, device=dev)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(0, 4, (V, 3)).astype(np.float32)).to(
        dev)
    species = torch.from_numpy(rng.integers(0, 5, V).astype(np.int32)).to(
        dev)

    out = {"edges": [], "losses": []}
    for it in range(20):
        # mutate the neighbor list: insert a few bonds, drop a few
        ns = rng.integers(0, V, 24).astype(np.uint32)
        nd = rng.integers(0, V, 24).astype(np.uint32)
        g = ensure_capacity(g, 32)
        g, _ = insert_edges(g, pad(ns, 32, dev), pad(nd, 32, dev))
        if it % 3 == 2:
            g, _ = delete_edges(g, pad(ns[:8], 16, dev), pad(nd[:8], 16, dev))

        snd, rcv, emask = edges_from_slab(g, max_edges=E_CAP)
        batch = GraphBatch(
            positions=pos, node_feat=None, species=species, senders=snd,
            receivers=rcv, edge_mask=emask,
            node_mask=torch.ones(V, dtype=torch.bool, device=dev),
            graph_ids=torch.zeros(V, dtype=torch.int32, device=dev),
            n_graphs=1)
        target = torch.tensor([float(np.sin(it))], dtype=torch.float32,
                              device=dev)
        params, ostate, loss = step(params, ostate, batch, target)
        out["edges"].append(int(emask.sum()))
        out["losses"].append(float(loss))
        print(f"step {it:02d}  edges={out['edges'][-1]:3d}  "
              f"loss={out['losses'][-1]:.4f}")
    print("gnn_molecules OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
