#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s GNN phase alone on one CUDA card, with kernel
4's row of phase 2.

    python3 tools/gnn_alone.py

Builds the kernels, builds the serve's RMAT scale-20 graph (seed 0) as a
forward view on the card directly (the full script takes the served view
after its updates), samples ``minibatch_lg``'s subgraph over it, holds and
times kernel 4's op on its transpose with PageRank's first contributions
(``chip_smoke.contrib_sums_row``), then runs ``chip_smoke.gnn_phase``: the
eleven full-width GNN cells, the not-run cells with their bytes, the step
and invariance gates with their planted faults, and the live NequIP loop.
Prints the card's name and power limit first, then the lines; exits 1
when a check failed and nonzero without a CUDA card.  About 2 minutes.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gnn_alone: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core.slab_graph import from_edges_host
    from repro_torch.core.worklist import transpose_host
    from repro_torch.data.synth import rmat_edges
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve as serve_mod

    print(cs.gpu_line(), flush=True)
    runtime.build()
    args = serve_mod.parse_args(cs.SERVE_ARGS)
    src, dst = rmat_edges(args.vertices, args.initial_edges, seed=args.seed)
    g = from_edges_host(args.vertices, src, dst, hashing=False,
                        device="cuda")
    try:
        sampled = cs.sampled_minibatch(torch, np, g,
                                       GNN_SHAPES["minibatch_lg"])
        cs.emit({"phase": "gnn_sample", **{
            k: v for k, v in sampled.items()
            if not isinstance(v, np.ndarray)}})
        gt = transpose_host(g, device="cuda")
        deg = torch.bincount(torch.from_numpy(src.astype(np.int64)).cuda(),
                             minlength=args.vertices).float()
        contrib = torch.where(deg > 0, 1.0 / args.vertices
                              / deg.clamp(min=1), 0.0)
        cs.emit({"phase": "kernels", **cs.contrib_sums_row(
            torch, dict(keys=gt.keys, slab_vertex=gt.slab_vertex,
                        values=contrib, n_vertices=args.vertices))})
        del g, gt
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cs.gnn_phase(torch, np, sampled)
    except cs.SmokeFailure as e:
        print(f"gnn_alone: check failed: {e}", flush=True)
        return 1
    cs.emit({"phase": "gnn", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
