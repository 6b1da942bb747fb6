#!/usr/bin/env python3
"""Time the serve phase's stream from this checkout and an earlier one,
in turns, each process serving it twice (cold, then warm).

    python3 tools/serve_ab.py --parent build/parent [--turns 2]

``--parent`` is an unpacked earlier checkout (``git archive``).  Each turn
runs ``launch.serve`` with ``chip_smoke.SERVE_ARGS`` in a fresh process of
each checkout (parent, this, this, parent, ...), twice in that process:
the second serve finds the kernels loaded and the allocator warm, as
``chip_smoke.py``'s phase 3 does after phase 2.  Prints one JSON line a
serve: the checkout, the run (0 cold, 1 warm) and each request's
host-clock ms.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CODE = """
import sys
from repro_torch.kernels import runtime
runtime.build()
from repro_torch.launch import serve
for run in range(2):
    print(f"[ab] run {run}", flush=True)
    serve.main(sys.argv[1:])
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    roots = {"this": ROOT, "parent": Path(args.parent).resolve()}
    order = ["parent", "this", "this", "parent"] * ((args.turns + 1) // 2)
    for name in order[:2 * args.turns]:
        env = dict(os.environ, PYTHONPATH=str(roots[name] / "src"))
        out = subprocess.run([sys.executable, "-c", _CODE, *cs.SERVE_ARGS],
                             cwd=roots[name], env=env, capture_output=True,
                             text=True, check=True).stdout
        for run, part in enumerate(out.split("[ab] run ")[1:]):
            ms = re.findall(r"\[serve\] req \d+ (\S+)\s+([\d.]+) ms", part)
            print(json.dumps({"checkout": name, "run": run,
                              "ms": [[k, float(v)] for k, v in ms]}),
                  flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
