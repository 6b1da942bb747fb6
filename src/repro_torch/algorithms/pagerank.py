"""Dynamic PageRank over the in-edge (transpose) view.

Per super-step: contributions ``PR[u] / out[u]``; the pool sweep sums them
over every vertex's in-neighbours; the mass of sinks is teleported; the L1
change decides convergence.  Dynamic PageRank warm-starts from the previous
vector.  Each iteration reads the L1 change on the host.

``contrib_impl`` picks the pool sweep, with the reference's values:
``"sweep"`` (alias ``"pallas"``, the port's default) is kernel 3's ``sum``
semiring through ``sweep_partials``; ``"ref"`` (the reference's default)
is kernel 4, ``kernels/slab_pagerank``, which sums every lane of a row.
``"ref"`` is there for callers written against the reference and for pools
whose rows are not packed; on the engine's pools, whose rows are packed,
both give the same vector and kernel 3 is the faster.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.hashing import SLAB_WIDTH
from ..core.slab_graph import SlabGraph
from ..core.worklist import pool_edges
from ..kernels.slab_pagerank import slab_contrib_sums_cuda
from ..kernels.slab_sweep.ops import sweep_partials


def slab_contrib_sums_ref(keys: torch.Tensor, valid: torch.Tensor,
                          contrib: torch.Tensor) -> torch.Tensor:
    """Per-slab sums of ``contrib`` over the valid lanes: the plain oracle
    of the ``sum`` sweep's partials.  keys (S, 128) int32, valid (S, 128)
    bool, contrib (V,) float32 -> (S,) float32."""
    idx = torch.where(valid, keys, 0).long()
    return torch.where(valid, contrib[idx], 0.0).sum(dim=1)


def _partials_fn(g_in: SlabGraph, contrib_impl: str):
    """contrib (V,) -> (S,) per-slab sums over ``g_in``'s pool."""
    if contrib_impl in ("sweep", "pallas"):
        return lambda contrib: sweep_partials(g_in, contrib, semiring="sum")
    if contrib_impl == "ref":
        # kernel 4 with the view's own owners: the reference's oracle over
        # ``pool_edges(g_in).valid``, whose rows are the owned ones
        return lambda contrib: slab_contrib_sums_cuda(
            g_in.keys, g_in.slab_vertex, contrib,
            n_vertices=g_in.n_vertices)
    raise ValueError(f"unknown contrib_impl {contrib_impl!r}")


def pagerank(g_in: SlabGraph, out_degree: torch.Tensor, *,
             init_pr: Optional[torch.Tensor] = None, damping: float = 0.85,
             error_margin: float = 1e-5, max_iter: int = 100,
             contrib_impl: str = "sweep") -> Tuple[torch.Tensor, int]:
    """Static (``init_pr=None``) or warm-started PageRank; (vector,
    iterations)."""
    partials = _partials_fn(g_in, contrib_impl)
    n = g_in.n_vertices
    dev = g_in.device
    seg = torch.where(g_in.slab_vertex >= 0, g_in.slab_vertex, n).long()
    pr = (torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
          if init_pr is None else init_pr.to(torch.float32))
    zero_out = out_degree == 0
    has_sink = zero_out.any()
    has_out = out_degree > 0
    deg = out_degree.clamp_min(1).to(torch.float32)
    it = 0
    go_on = True
    while go_on and it < max_iter:
        contrib = torch.where(has_out, pr / deg, 0.0)
        partial = partials(contrib)
        sums = torch.zeros(n + 1, dtype=torch.float32,
                           device=dev).index_add_(0, seg, partial)[:n]
        new_pr = (1.0 - damping) / n + damping * sums
        teleport = torch.where(zero_out, pr, 0.0).sum() / n
        new_pr = torch.where(has_sink, new_pr + damping * teleport, new_pr)
        # compared in float32, as the reference compares
        go_on = bool((new_pr - pr).abs().sum() > error_margin)
        pr = new_pr
        it += 1
    return pr, it


def pagerank_dynamic(g_in: SlabGraph, out_degree: torch.Tensor,
                     prev_pr: torch.Tensor, **kw):
    """Incremental and decremental PageRank: a warm start from the vector
    before the batch."""
    return pagerank(g_in, out_degree, init_pr=prev_pr, **kw)


def stream_property(*, damping: float = 0.85, error_margin: float = 1e-5,
                    max_iter: int = 100, contrib_impl: str = "sweep"):
    """PropertySpec: PageRank over the store's transpose view with the
    forward view's degrees; every batch is a warm start, so lazy catch-up
    runs it once however many epochs it missed."""
    from ..stream.properties import PropertySpec

    def _run(store, init_pr=None):
        if store.transpose is None:
            raise ValueError("the pagerank stream property sweeps the "
                             "transpose view; build the store with "
                             "with_transpose=True")
        pr, _ = pagerank(store.transpose, store.out_degree, init_pr=init_pr,
                         damping=damping, error_margin=error_margin,
                         max_iter=max_iter, contrib_impl=contrib_impl)
        return pr

    return PropertySpec(
        name="pagerank", init=lambda store: _run(store),
        on_batch=lambda store, state, batch: _run(store, init_pr=state),
        refresh=lambda store: _run(store),
        state_like=lambda n: torch.zeros(n, dtype=torch.float32),
        collapse_replay=True)
