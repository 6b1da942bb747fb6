"""Build, load and count the hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
libraries go to ``build/repro_torch/`` at the root of the checkout (ignored
by git), named by a hash of their source and the local headers it includes
(``#include "..."``, found beside it), so an edited source or header is
rebuilt and an unchanged one is reused.  Nothing is built when a module is imported: the
first launch of a kernel builds its library, and ``build()`` builds all of
them at once (one ``nvcc`` per source, all started together).

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("slab_update", "slab_sweep", "slab_pagerank", "slab_compact",
           "slab_intersect", "flash_attention", "flash_attention_bwd",
           "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"slab_probe": 0, "slab_commit": 0,
                            "slab_sweep": 0, "slab_contrib_sums": 0,
                            "slab_live": 0,
                            "slab_chain_rank": 0, "slab_count": 0,
                            "probe_hits": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "embedding_bag": 0}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources(path: Path) -> List[Path]:
    """``path`` and the local headers it includes, directly or through
    another header, each once, in the order they are first included."""
    seen: List[Path] = []
    todo = [path]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        todo += [p.parent / h for h in re.findall(
            r'^\s*#\s*include\s*"([^"]+)"', p.read_text(), re.MULTILINE)
            if (p.parent / h).is_file()]
    return seen


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in _sources(CSRC / f"{name}.cu")) +
        " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES, *, verbose: bool = False) -> Dict[str, dict]:
    """Compile every named source that is not built yet, in parallel.

    Returns ``{name: {"path", "seconds", "log"}}``; ``verbose`` passes
    ``-Xptxas -v`` so the log lists each kernel's registers and spills.
    Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        path = _lib_path(name)
        if path.is_file() and not verbose:
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, path)
    failed = []
    for name, (proc, t0, tmp, path) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.is_file():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of ``t`` for ctypes (None for a missing operand)."""
    return None if t is None else t.data_ptr()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, lib: ctypes.CDLL, error_fn: str, kernel: str):
    """Raise if the C entry reported a launch error."""
    if rc != 0:
        msg = getattr(lib, error_fn)(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (code {rc})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device,
            shape=None, align: int = 4) -> None:
    """Check one kernel operand: device, dtype, shape, contiguity, alignment."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
