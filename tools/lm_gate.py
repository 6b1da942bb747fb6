#!/usr/bin/env python3
"""Read phase 5's decode gates at another seed on one CUDA card.

    python3 tools/lm_gate.py --seed 1 [--kernels-from DIR]

Runs ``chip_smoke.lm_phase`` with gemma2-9b's weights and prompts drawn from
``--seed`` (``chip_smoke.py`` itself uses seed 0): the full-width bf16 serve,
its ``lm_check`` line (the clean decode against ``forward`` over 128 steps,
and the first 16 steps again with the position and the ring slot off by
one, in bf16 and in float32) and the kernel-10 lines.  Prints the card's
name and power limit first and whether every gate held last; exits 1 when
one failed.  ``--kernels-from DIR`` builds the kernels from the sources of
another checkout (an unpacked earlier commit), so that the same phase
times an earlier kernel.  Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--kernels-from", type=Path, default=None,
                    help="build the kernels from this checkout's sources "
                         "(an unpacked earlier commit) instead")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lm_gate: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import runtime

    if args.kernels_from is not None:
        runtime.CSRC = args.kernels_from / "src" / "repro_torch" / "csrc"
    print(cs.gpu_line(), flush=True)
    built = runtime.build(tuple(n for n in runtime.SOURCES
                                if (runtime.CSRC / f"{n}.cu").is_file()),
                          verbose=True)
    try:
        cs.lm_phase(torch, np, built["flash_attention"],
                    built.get("flash_attention_bwd"), seed=args.seed)
    except cs.SmokeFailure as e:
        print(f"lm_gate: seed {args.seed}: a gate failed: {e}", flush=True)
        return 1
    print(f"lm_gate: seed {args.seed}: every gate held", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
