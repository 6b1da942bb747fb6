#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s train phase alone on one CUDA card.

    python3 tools/train_alone.py

Builds the kernels and checks the attention build (no spills, forward and
backward), then runs ``chip_smoke.train_phase`` with gemma2-9b's first
local and global layer and qwen3-moe's layer 0 drawn at their shapes from
a seeded generator (bf16, standard normal; the full script takes them from
its LM and MoE phases): gemma-2b trained at full width, kernel 10's
backward against its plain version with planted faults, the step checks
at 2 layers and MIND's training.  Prints the card's name and power limit
first, then the phase's lines; exits 1 when a check failed and nonzero
without a CUDA card.  About 4 minutes; it keeps two ~8.9 GB checkpoints
under the temp directory at once.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (name, (B, Hq, Hkv, S, D), the layer's attention options)
LAYERS = (
    ("gemma2-9b local (layer 0)", (2, 16, 8, 8192, 256),
     {"causal": True, "window": 4096, "softcap": 50.0}),
    ("gemma2-9b global (layer 1)", (2, 16, 8, 8192, 256),
     {"causal": True, "window": 0, "softcap": 50.0}),
    ("qwen3-moe layer 0", (2, 32, 4, 8192, 128),
     {"causal": True, "window": 0, "softcap": 0.0}),
)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_alone: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import runtime

    print(cs.gpu_line(), flush=True)
    built = runtime.build(verbose=True)
    cs.check_attention_build(runtime, built["flash_attention"],
                             built["flash_attention_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(11)
    captured = {}
    for name, (B, Hq, Hkv, S, D), kw in LAYERS:
        captured[name] = tuple(
            torch.randn(s, generator=gen, device="cuda")
            .to(torch.bfloat16).cpu()
            for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))) + (kw,)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        cs.train_phase(torch, np, captured)
    except cs.SmokeFailure as e:
        print(f"train_alone: check failed: {e}", flush=True)
        return 1
    cs.emit({"phase": "train", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
