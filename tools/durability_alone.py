#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s durability phase alone on one CUDA card.

    python3 tools/durability_alone.py

Builds the kernels, serves the serve phase's stream at RMAT scale 20
(keeping host copies of the views as booted), then runs
``chip_smoke.durability_phase`` on those copies and the serve's first three
update batches: the twin, and a kill, ``recover`` and re-feed at
``apply.admitted`` and ``apply.post_wal``, held to the twin bit for bit.
Prints the card's name and power limit first, then the phase's
``durability`` lines; exits 1 when a check failed and nonzero without a
CUDA card.  About 3 minutes, most of it the boot's host sorts.
"""
from __future__ import annotations

import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("durability_alone: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch.stream as stream_mod
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve as serve_mod

    print(cs.gpu_line(), flush=True)
    runtime.build()
    boot = {}
    with cs.keeping_boot(stream_mod, boot):
        out = serve_mod.main(cs.SERVE_ARGS)
    updates = [req for kind, req, _, _ in out["responses"]
               if kind == "update"][:3]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    try:
        cs.durability_phase(torch, np, boot, updates)
    except cs.SmokeFailure as e:
        print(f"durability_alone: check failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
