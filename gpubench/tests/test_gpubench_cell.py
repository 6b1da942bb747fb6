"""A throwaway cell, added from files alone, runs end to end through the
port's CPU path; the command refuses to run without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpubench.tests._tiny import REPO, run_tiny, tiny_root

E2E = {"fresh_p95_ms", "fresh_edges_per_s", "bytes_per_edge", "setup_s"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_tiny_cell_line_is_well_formed(root):
    before = {p.relative_to(REPO / "gpubench") for p in
              (REPO / "gpubench").rglob("*") if "__pycache__" not in str(p)}
    added = {p.relative_to(root / "gpubench") for p in
             (root / "gpubench").rglob("*") if "__pycache__" not in str(p)}
    assert before <= added            # only new files beside the old
    result = run_tiny(root, seconds=4.0)
    line = json.loads(json.dumps(result))
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == E2E
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "B/edge"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert list(line)[-1] == "checks"
    assert all(set(row) == {"value", "limit"}
               for row in line["checks"].values())


def test_tiny_cell_traced(root):
    line = run_tiny(root, seconds=1.0, trace=True)
    assert line["correct"] is True
    names = set(line["metrics"])
    assert {"pipeline_self_ms", "apply_ms", "dedup_ms", "read_ms.pagerank",
            "read_ms.bfs_0", "read_ms.wcc", "launches_per_round"} <= names
    assert not names & E2E
    # no card: no device trace, so nothing read from one
    assert not names & {"idle_share", "window_mfu", "sweep_roofline",
                        "update_roofline"}


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "kron20.fresh",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_command_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run(tmp_path, env={"PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "kron20.fresh",
         "--seed", "2147483701", "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def test_weighted_deployment_is_refused(tmp_path):
    """A configuration key the harness cannot honour stops the run."""
    root = tiny_root(tmp_path)
    path = root / "gpubench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg["deployment"]["weighted"] = True
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="weighted"):
        run_tiny(root, seconds=0.2)


def test_new_client_and_property_kind_from_files_alone(tmp_path):
    """A mix may name a client of its own and a configuration a property
    kind of its own: each is a new file, found by its name."""
    root = tiny_root(tmp_path)
    g = root / "gpubench"
    shutil.copy(g / "mixes" / "closed_rounds.py", g / "mixes" / "other.py")
    shutil.copy(g / "properties" / "wcc.py", g / "properties" / "wcc2.py")
    mix = json.loads((g / "mixes" / "tinymix.json").read_text())
    (g / "mixes" / "tinymix.json").write_text(json.dumps(
        {**mix, "client": "other"}))
    cfg = json.loads((g / "configs" / "tiny.json").read_text())
    for p in cfg["properties"]:
        if p["kind"] == "wcc":
            p["kind"] = "wcc2"
    (g / "configs" / "tiny.json").write_text(json.dumps(cfg))
    line = run_tiny(root, seconds=0.5)
    assert line["correct"] is True, line["checks"]
    assert "wcc_wrong" in line["checks"]
