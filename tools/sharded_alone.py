#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded and mesh phases alone on one CUDA card.

    python3 tools/sharded_alone.py

Builds the kernels, serves the serve phase's stream at RMAT scale 20 on
the unsharded store (phase 3's answers are the reference), then runs
``chip_smoke.sharded_phase``: the same stream on a ``ShardedGraphStore``
of four shards with ``--health`` and ``--metrics``, held to phase 3's
answers, a planted SLO fault and the booted view's triangle count; then
``chip_smoke.mesh_phase``: the booted store on four gloo ranks sharing the
card, one shard a rank, held to the sharded phase leaf for leaf, and one
NCCL rank.  Prints the card's name and power limit first, then phase 3's
serve line and the phases' lines; exits 1 when a check failed and
nonzero without a CUDA card.  Needs about 4.5 GB free under ``$TMPDIR``
(the booted store's checkpoint).
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sharded_alone: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve as serve_mod

    print(cs.gpu_line(), flush=True)
    t0 = time.perf_counter()
    runtime.build()
    out = serve_mod.main(cs.SERVE_ARGS)
    torch.cuda.synchronize()
    cs.emit({"phase": "serve", "boot_s": out["boot_s"],
             "serve_s": out["serve_s"], "latency": out["latency"]})
    ref3 = cs.served_reference(torch, np, out)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    import tempfile
    try:
        with tempfile.TemporaryDirectory() as mesh_dir:
            res = cs.sharded_phase(torch, np, ref3, Path(mesh_dir))
            gc.collect()
            torch.cuda.empty_cache()
            cs.mesh_phase(torch, np, res)
    except cs.SmokeFailure as e:
        print(f"sharded_alone: check failed: {e}", file=sys.stderr)
        return 1
    cs.emit({"phase": "sharded_alone", "triangles": res["triangles"],
             "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
