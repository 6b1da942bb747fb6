"""Shared GNN substrate, from ``repro.models.gnn.common``: graph batches,
radial bases, segment message passing.

Message passing runs over an explicit edge index: a segment sum is
``index_add``, a segment max ``scatter_reduce(..., "amax")`` over a tensor
filled with ``-inf`` (JAX's ``segment_max`` leaves an empty segment at
``-inf`` too, and both split a max's gradient evenly among tied elements).
Graphs come from tensors or from a live ``SlabGraph`` (``edges_from_slab``):
the Meerkat substrate is the dynamic source of GNN topology.

Departures from the reference:

* ``init_mlp``, ``random_geometric_batch`` and ``random_feature_graph``
  take a ``torch.Generator`` and make their tensors on its device: the same
  distributions and structure, not JAX's threefry numbers.
* ``GraphBatch`` is a frozen dataclass of tensors with ``.to(device)``;
  ``params_from_numpy`` carries the reference's parameter trees across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded, fixed-shape graph batch.

    senders/receivers: (E,) int32 (message j->i uses senders=j receivers=i);
    padded edges carry edge_mask=False and point at node 0.
    graph_ids: (N,) int32 segment ids for batched small graphs (molecule
    shape); 0 everywhere for single graphs.
    """
    positions: Optional[torch.Tensor]   # (N, 3) or None
    node_feat: Optional[torch.Tensor]   # (N, F) or None
    species: Optional[torch.Tensor]     # (N,) int32 or None
    senders: torch.Tensor               # (E,)
    receivers: torch.Tensor             # (E,)
    edge_mask: torch.Tensor             # (E,) bool
    node_mask: torch.Tensor             # (N,) bool
    graph_ids: torch.Tensor             # (N,) int32
    n_graphs: int

    @property
    def n_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_mask.shape[0]

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def edges_from_slab(g, *, max_edges: int):
    """Dynamic topology: senders/receivers straight out of the slab pool,
    in pool order, the first ``max_edges`` live lanes kept (int32), and
    the mask of the filled slots."""
    from ...core.worklist import pool_edges
    view = pool_edges(g)
    src = view.src.reshape(-1)
    dst = view.dst.reshape(-1)
    ok = view.valid.reshape(-1)
    m = ok.to(torch.int32)
    pos = torch.cumsum(m, 0, dtype=torch.int32) - m
    # slot max_edges takes what the reference's scatter drops
    idx = torch.where(ok & (pos < max_edges), pos, max_edges).long()
    dev = src.device
    senders = torch.zeros(max_edges + 1, dtype=torch.int32, device=dev)
    receivers = torch.zeros(max_edges + 1, dtype=torch.int32, device=dev)
    senders[idx] = src.to(torch.int32)
    receivers[idx] = dst.to(torch.int32)
    n = torch.clamp(m.sum(), max=max_edges)
    emask = torch.arange(max_edges, device=dev) < n
    return senders[:max_edges], receivers[:max_edges], emask


# ---------------------------------------------------------------------------
# radial bases
# ---------------------------------------------------------------------------

def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """(E,) -> (E, n_rbf): sin(n pi r / c) / r basis (NequIP/MACE)."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rc = torch.clamp(r, 1e-5, cutoff)
    return (math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rc[:, None]
                                                / cutoff) / rc[:, None])


def poly_cutoff(r: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial envelope, 1 at 0 -> 0 at cutoff (DimeNet form)."""
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    return 1.0 + a * x ** p + b * x ** (p + 1) + c * x ** (p + 2)


def gaussian_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    mu = torch.linspace(0.0, cutoff, n_rbf, device=r.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (r[:, None] - mu) ** 2)


# ---------------------------------------------------------------------------
# segment helpers
# ---------------------------------------------------------------------------

def segment_sum(x: torch.Tensor, segs: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``x`` added into their segment."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add(0, segs.long(), x)


def segment_max(x: torch.Tensor, segs: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment is ``-inf``."""
    idx = segs.long().reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out = x.new_full((num_segments,) + tuple(x.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, idx, x, "amax", include_self=False)


def segment_softmax(logits: torch.Tensor, segs: torch.Tensor,
                    num_segments: int, mask: torch.Tensor) -> torch.Tensor:
    logits = torch.where(mask, logits, -1e30)
    mx = segment_max(logits, segs, num_segments)
    ex = torch.where(mask, torch.exp(logits - mx[segs.long()]), 0.0)
    den = segment_sum(ex, segs, num_segments)
    return ex / torch.clamp(den[segs.long()], min=1e-20)


def degrees(receivers: torch.Tensor, mask: torch.Tensor,
            n_nodes: int) -> torch.Tensor:
    return segment_sum(mask.to(torch.float32), receivers, n_nodes)


# ---------------------------------------------------------------------------
# tiny functional MLP
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, dims, dtype=torch.float32) -> Dict:
    dev = generator.device
    out = {f"w{i}": (torch.randn((dims[i], dims[i + 1]), generator=generator,
                                 device=dev) * dims[i] ** -0.5).to(dtype)
           for i in range(len(dims) - 1)}
    out.update({f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype,
                                     device=dev)
                for i in range(len(dims) - 1)})
    return out


def apply_mlp(p: Dict, x: torch.Tensor, act=F.silu,
              final_act: bool = False) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def params_from_numpy(tree, device):
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's, under the same keys, on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)


# ---------------------------------------------------------------------------
# synthetic batch builders (smoke tests / benchmarks)
# ---------------------------------------------------------------------------

def _repeat_ids(n_groups: int, per: int, total: int, dev) -> torch.Tensor:
    """``jnp.repeat(arange(n_groups), per, total_repeat_length=total)``:
    each id ``per`` times, the last id repeated to fill ``total``."""
    ids = torch.arange(total, device=dev) // max(per, 1)
    return torch.clamp(ids, max=n_groups - 1).to(torch.int32)


def random_geometric_batch(generator: torch.Generator, n_nodes: int,
                           n_edges: int, *, n_species: int = 10,
                           cutoff: float = 5.0,
                           n_graphs: int = 1) -> GraphBatch:
    dev = generator.device
    pos = torch.rand((n_nodes, 3), generator=generator, device=dev) \
        * (n_nodes ** (1 / 3)) * 2.0
    # kNN-ish random edges within the batch's graph partition
    per = n_nodes // n_graphs
    gid = _repeat_ids(n_graphs, per, n_nodes, dev)
    snd = torch.randint(0, per, (n_edges,), generator=generator, device=dev)
    rcv = torch.randint(0, per, (n_edges,), generator=generator, device=dev)
    off = _repeat_ids(n_graphs, n_edges // n_graphs, n_edges, dev) * per
    snd = snd + off
    rcv = rcv + off
    ok = snd != rcv
    species = torch.randint(0, n_species, (n_nodes,), generator=generator,
                            device=dev).to(torch.int32)
    return GraphBatch(positions=pos, node_feat=None, species=species,
                      senders=snd.to(torch.int32),
                      receivers=rcv.to(torch.int32), edge_mask=ok,
                      node_mask=torch.ones(n_nodes, dtype=torch.bool,
                                           device=dev),
                      graph_ids=gid, n_graphs=n_graphs)


def random_feature_graph(generator: torch.Generator, n_nodes: int,
                         n_edges: int, d_feat: int) -> GraphBatch:
    dev = generator.device
    feat = torch.randn((n_nodes, d_feat), generator=generator, device=dev)
    snd = torch.randint(0, n_nodes, (n_edges,), generator=generator,
                        device=dev).to(torch.int32)
    rcv = torch.randint(0, n_nodes, (n_edges,), generator=generator,
                        device=dev).to(torch.int32)
    return GraphBatch(positions=None, node_feat=feat, species=None,
                      senders=snd, receivers=rcv,
                      edge_mask=torch.ones(n_edges, dtype=torch.bool,
                                           device=dev),
                      node_mask=torch.ones(n_nodes, dtype=torch.bool,
                                           device=dev),
                      graph_ids=torch.zeros(n_nodes, dtype=torch.int32,
                                            device=dev), n_graphs=1)
