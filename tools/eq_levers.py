#!/usr/bin/env python3
"""EquiformerV2's dry-run levers on one CUDA card: a train step of the full
config on the ``molecule`` shape (128 graphs, 3,840 nodes, 8,192 edges)
with no lever, each lever alone and all three.

    python3 tools/eq_levers.py

For each variant: ``STEPS`` steps of ``build_gnn_train_step`` (the first
cold), the median warm ms and the peak bytes; then one step of the
variant with all three levers under ``torch.profiler``, its card time by
kernel name (the top entries) and its launch count.  Prints the card's
name and power limit first, one JSON line a variant, then the profile;
exits nonzero without a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
VARIANTS = {
    "plain": {},
    "bf16": {"compute_dtype": "bfloat16"},
    "edge_chunks2": {"edge_chunks": 2},
    "trunc_rotation": {"trunc_rotation": True},
    "all": {"compute_dtype": "bfloat16", "edge_chunks": 2,
            "trunc_rotation": True},
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("eq_levers: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn.common import random_geometric_batch
    from repro_torch.train import optimizer as opt

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    module, style = S._GNN["equiformer-v2"]
    shape = GNN_SHAPES["molecule"]
    N, E, G = S.gnn_size(shape)
    base = get_arch("equiformer-v2").full_config()

    def setup(flags):
        flags = dict(flags)
        if "compute_dtype" in flags:
            flags["compute_dtype"] = getattr(torch, flags["compute_dtype"])
        cfg = dataclasses.replace(base, **flags)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = random_geometric_batch(gen, N, E, n_graphs=G,
                                       n_species=cfg.n_species)
        targets = torch.randn((G,), generator=gen, device="cuda")
        params = module.init_params(cfg, gen)
        return cfg, batch, targets, params, opt.init(params)

    for name, flags in VARIANTS.items():
        cfg, batch, targets, params, state = setup(flags)
        step = S.build_gnn_train_step(module, cfg, style)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batch, targets)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        print(json.dumps({"variant": name, "levers": flags, "step_ms": ms,
                          "warm_ms_median": statistics.median(ms[1:]),
                          "loss": float(loss),
                          "peak_bytes": torch.cuda.max_memory_allocated()}),
              flush=True)
        del params, state, batch
        torch.cuda.empty_cache()

    from torch.profiler import ProfilerActivity, profile
    cfg, batch, targets, params, state = setup(VARIANTS["all"])
    step = S.build_gnn_train_step(module, cfg, style)
    step(params, state, batch, targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch, targets)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=15)
    print(table)
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
