"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``) on the CPU.

Each reference example runs as a user runs it, in a subprocess with
``JAX_PLATFORMS=cpu``; each port example runs in-process through its
``main(device="cpu")``, whose printed lines are compared with the
reference's:

* quickstart and streaming_analytics: every printed line equal, timings
  aside, PageRank's top within ``PR_ATOL`` (the sweep sums in another
  order);
* gnn_molecules: with the reference's ``PRNGKey(0)`` weights carried
  across (``params_from_numpy``), the 20 edge counts equal and each loss
  within ``GNN_LOSS_TOL`` of the reference's printed one;
* train_lm: both at ``--steps 2 --batch 2 --seq-len 32`` in temporary
  directories print finite losses, and the port's run resumes from its
  checkpoint.
"""
import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PR_ATOL = 2e-5
#: a loss's distance from the reference's, on top of its printed rounding
#: (4 decimals): float32 sums in another order over 20 AdamW steps
GNN_LOSS_TOL = 1e-3
#: the per-response latency the streaming example prints
_LATENCY = re.compile(r"\s+[0-9.]+ ms ")


def run_reference(name: str, *args: str) -> list:
    """The reference example's stdout lines, run as a user runs it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(EXAMPLES / name), *args],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.splitlines()


def port_example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(capsys, name: str, **kw):
    """(the port example's ``main`` result, its stdout lines)."""
    capsys.readouterr()
    got = port_example(name).main(**kw)
    return got, capsys.readouterr().out.splitlines()


def assert_lines_match(got: list, want: list):
    """Line for line, the latencies dropped and PageRank's top within
    PR_ATOL."""
    assert len(got) == len(want), (got, want)
    top = re.compile(r"top=([0-9.]+)")
    for g, w in zip(got, want):
        g, w = _LATENCY.sub(" ", g), _LATENCY.sub(" ", w)
        tg, tw = top.search(g), top.search(w)
        if tw:
            assert abs(float(tg.group(1)) - float(tw.group(1))) <= PR_ATOL
            g, w = top.sub("top=", g), top.sub("top=", w)
        assert g == w


def test_quickstart_matches_reference(capsys):
    want = run_reference("quickstart.py")
    got, lines = run_port(capsys, "torch_quickstart", device="cpu")
    assert_lines_match(lines, want)
    assert got["found"] == [True] * 4 and got["deleted"] > 0


def test_streaming_analytics_matches_reference(capsys):
    want = run_reference("streaming_analytics.py")
    got, lines = run_port(capsys, "torch_streaming_analytics", device="cpu")
    assert_lines_match(lines, want)
    assert got["maintenance_passes"] >= 1
    assert got["membership_identical"] and got["wcc_identical"]


def test_gnn_molecules_matches_reference(capsys):
    import jax
    from repro.models.gnn import nequip as jnequip
    mod = port_example("torch_gnn_molecules")
    cfg = jnequip.NequIPConfig(**{k: getattr(mod.cfg, k) for k in (
        "n_layers", "channels", "n_species")})
    init = jax.tree.map(np.asarray,
                        jnequip.init_params(cfg, jax.random.PRNGKey(0)))
    want = run_reference("gnn_molecules.py")
    got, lines = run_port(capsys, "torch_gnn_molecules", device="cpu",
                          params=init)
    step = re.compile(r"step (\d+)\s+edges=\s*(\d+)\s+loss=(-?[0-9.]+)")
    rows = [step.match(w).groups() for w in want if step.match(w)]
    assert len(rows) == len(got["edges"]) == 20
    assert got["edges"] == [int(e) for _, e, _ in rows]
    for i, (_, _, loss) in enumerate(rows):
        assert abs(got["losses"][i] - float(loss)) <= GNN_LOSS_TOL + 5e-5, i
    assert lines[-1] == want[-1] == "gnn_molecules OK"


def test_train_lm_trains_and_resumes(capsys, tmp_path):
    args = ["--steps", "2", "--batch", "2", "--seq-len", "32"]
    want = run_reference("train_lm.py", *args, "--ckpt-dir",
                         str(tmp_path / "ref"))
    done = [w for w in want if w.startswith("[train] done")]
    assert len(done) == 1
    assert all(math.isfinite(float(x))
               for x in re.findall(r"loss (-?[0-9.]+)", done[0]))
    port = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]
    got, lines = run_port(capsys, "torch_train_lm", argv=args + port)
    assert len(got["losses"]) == 2 and got["final_step"] == 2
    assert all(math.isfinite(x) for x in got["losses"])
    assert lines[-1].startswith("[train] done: first-10 loss ")
    args[1] = "3"
    got, lines = run_port(capsys, "torch_train_lm", argv=args + port)
    assert "[loop] resumed from step 2" in lines
    assert len(got["losses"]) == 1 and got["final_step"] == 3
    assert math.isfinite(got["losses"][0])


def test_examples_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("the card is present: cuda is a valid default")
    for name in ("torch_quickstart", "torch_streaming_analytics",
                 "torch_gnn_molecules"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_example(name).main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_example("torch_train_lm").main(["--steps", "1"])
