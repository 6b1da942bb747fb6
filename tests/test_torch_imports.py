"""The port runs without JAX: every module of ``repro_torch``, and
``chip_smoke.py``, imports in a process where ``import jax``, ``import
repro``, ``import msgpack`` and ``import ml_dtypes`` fail (the card's
machine has none of them).  The walk over the package must reach the
modules of the health engine, the kernel instrumentation and the sharded
plane."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["msgpack"] = None
sys.modules["ml_dtypes"] = None
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "ml_dtypes")
             and sys.modules[m] is not None)
missing = sorted({"repro_torch.obs.health", "repro_torch.obs.instrument",
                  "repro_torch.distributed.collectives",
                  "repro_torch.distributed.sharded_graph",
                  "repro_torch.stream.sharded_store"} - set(names))
print(len(names), missing, bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.split(maxsplit=1)
    assert int(n) > 20, out.stdout
    assert rest.strip() == "[] []", out.stdout
