"""The control (each property kind's reference one precision below the
configuration's, bfloat16 PageRank for float32, in the program's place)
comes out not correct through the harness's own comparison, and sound
runs come out correct; at a size a test run holds.  On the card,
``gpubench/control.py`` runs it at the cell's own size."""
import json
import subprocess
import sys
import time

import pytest
import torch

from gpubench.harness.cell import run_cell
from gpubench.reference.edges import EdgeLog, after_round
from gpubench.reference.pagerank import pagerank, pagerank_l1
from gpubench.tests._tiny import CELL, REPO, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("control"), scale=11, batch=1024)


def limit(root):
    return json.loads((root / "gpubench" / "limits" / f"{CELL}.json")
                      .read_text())["limits"]["pagerank_l1"]


def run(root, seed, control):
    return run_cell(root, CELL, seed, 1.0, False, "cpu",
                    time.perf_counter(), lambda msg: None, control=control)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 77])
def test_control_is_not_correct(root, seed):
    res = run(root, seed, control=True)
    assert res["correct"] is False
    failing = {n for n, row in res["checks"].items()
               if row["value"] > row["limit"]}
    assert failing == {"pagerank_l1"}
    assert res["checks"]["pagerank_l1"]["value"] > 3 * limit(root)


@pytest.mark.parametrize("seed", [13, 2 ** 31 + 8])
def test_sound_run_passes_the_limit(root, seed):
    res = run(root, seed, control=False)
    row = res["checks"]["pagerank_l1"]
    assert res["correct"] is True and row["value"] < row["limit"] / 3


def test_float64_at_the_same_margin_passes(root):
    """The control fails by its precision: the same iteration in float64,
    stopped at the configuration's error margin, stays far under the
    limit."""
    from gpubench.harness.cell import Manifest, draw_initial, graph_of
    man = Manifest(root)
    cfg = man.config(man.cell(CELL)["config"])
    graph = graph_of(cfg)
    V = 1 << graph["scale"]
    initial, _ = draw_initial(graph, torch.device("cpu"))
    keys = EdgeLog(V, initial, []).edges_at(after_round(-1))
    (pr,) = [p for p in cfg["properties"] if p["kind"] == "pagerank"]
    want = pagerank(keys, V, damping=pr["damping"], tol=1e-12, max_iter=2000)
    at_margin = pagerank(keys, V, damping=pr["damping"],
                         tol=pr["error_margin"], max_iter=pr["max_iter"])
    assert pagerank_l1(at_margin, want) < limit(root) / 10


@pytest.mark.gpu
def test_control_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "gpubench/control.py", "--workload", "kron20.fresh",
         "--seconds", "10", "--seeds", "101"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["control"] and line["correct"] is False
