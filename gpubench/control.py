"""The control of a cell: runs of the cell in which each property kind's
control, the plain reference one precision below the configuration's
(bfloat16 PageRank for float32), is put in the program's place at every
checked round, judged by the harness's own comparison.  Each such run has
to come out not correct.  ``--sound`` seeds run the program itself in the
same process, for the lower readings.

    python3 gpubench/control.py --workload kron20.fresh --seconds 10 \\
        --seeds 1 2 3 --sound 4 5 6

One JSON line a run: the seed, whether it was the control, ``correct``
and each number beside its limit.  Exits 1 if a control run came out
correct or a sound run did not.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(root: Path, workload: str, seed: int, seconds: float, control: bool,
        device: str = "cuda", log=lambda msg: None) -> dict:
    from gpubench.harness.cell import run_cell
    return run_cell(root, workload, seed, seconds, False, device,
                    time.perf_counter(), log, control=control)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from run import cache_env
    cache_env(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ok = True
    for seed, control in ([(s, True) for s in args.seeds]
                          + [(s, False) for s in args.sound]):
        res = run(ROOT, args.workload, seed, args.seconds, control,
                  args.device,
                  lambda msg: print(msg, file=sys.stderr, flush=True))
        ok &= res["correct"] is not control
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
