"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload kron20.fresh --seed 7 --seconds 30 \\
        --trace 0

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The set-up's phases, the window's count and each number
compared with its limit go to standard error; the last line of standard
output is the result: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device`` (and ``breakdown`` when traced), then ``checks``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a checkout's first run builds."""
    base = root / "build" / "gpubench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_env(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from gpubench.harness.cell import Manifest, run_cell

    chips = Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[gpubench] needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, log)
    found = forbidden_modules()
    if found:
        log(f"[gpubench] the measured process loaded {found}")
        return 3
    for name, row in result["checks"].items():
        log(f"[check] {name} {row['value']} limit {row['limit']}")
    log(f"[check] correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
