"""A throwaway cell added to a copy of the benchmark from files alone: a
configuration, a mix, its limits and new entries in ``BENCHMARK.json``;
no file of the benchmark is edited."""
import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny.fresh"


def tiny_root(dst: Path, *, scale: int = 9, batch: int = 256) -> Path:
    shutil.copytree(REPO / "gpubench", dst / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    g = dst / "gpubench"
    cfg = json.loads((g / "configs" / "kron20.json").read_text())
    cfg.update(name="tiny", scale=scale)
    cfg["deployment"]["slack_slabs"] = 64
    (g / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((g / "mixes" / "fresh.json").read_text())
    mix.update(name="tinymix", batch=batch, member_pairs=64,
               checked_from_first=4, warmup_rounds=1)
    (g / "mixes" / "tinymix.json").write_text(json.dumps(mix))
    (g / "limits" / f"{CELL}.json").write_text(
        (g / "limits" / "kron20.fresh.json").read_text())
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a tiny R-MAT graph",
                             "file": "gpubench/configs/tiny.json",
                             "reduced": ["scale"], "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "tinymix", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run_tiny(root: Path, *, seconds: float = 1.0, trace: bool = False,
             seed: int = 2 ** 31 + 11):
    from gpubench.harness.cell import run_cell
    return run_cell(root, CELL, seed, seconds, trace, "cpu",
                    time.perf_counter(), lambda msg: None)
