"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names, and the reference loads nothing of the program."""
import json
import subprocess
import sys

from gpubench.tests._tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = r"""
import json, sys, time
sys.path[:0] = [{repo!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body):
    code = PROBE.format(repo=str(REPO), src=str(REPO / "src"), body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import gpubench.reference.edges\n"
                  "import gpubench.reference.pagerank\n"
                  "import gpubench.reference.bfs\n"
                  "import gpubench.reference.wcc\n"
                  "import gpubench.control")
    assert not mods & FORBIDDEN
    assert "repro_torch" not in mods


def test_a_run_loads_no_jax(tmp_path):
    body = ("from pathlib import Path\n"
            "from gpubench.tests._tiny import tiny_root, run_tiny\n"
            f"root = tiny_root(Path({str(tmp_path)!r}))\n"
            "res = run_tiny(root, seconds=0.5, trace=True)\n"
            "assert res['correct'], res['checks']\n")
    mods = loaded(body)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_the_check_compares_whole_names():
    sys.path.insert(0, str(REPO / "gpubench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    assert "repro_torch" not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN
