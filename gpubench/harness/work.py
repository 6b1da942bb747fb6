"""Needed bytes per operation family, counted at the program's kernel
entry points.

Each file ``gpubench/work/<family>.py`` names the entry points it counts
(``HOOKS``: (module, attribute) -> function of the file) and the device
kernels that do its work (``KERNELS``: name patterns in the device
trace).  ``Counter.install`` wraps each entry point so that every call
adds its needed bytes, counted from the call's inputs and its answer, to
its family; the sums are device scalars, read once at the end.

The counts run in an untraced replay of the traced window's rounds, never
inside the traced window, so that the device trace and the spans hold the
program's work alone.
"""
from __future__ import annotations

import importlib
import importlib.util
import re
from pathlib import Path
from typing import Dict, List, Tuple

import torch


def load_family(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"gpubench_work_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def families(root: Path) -> Dict[str, object]:
    """Every family file under ``gpubench/work``, by name."""
    return {p.stem: load_family(p)
            for p in sorted((root / "gpubench" / "work").glob("*.py"))}


def kernel_family(name: str, fams: Dict[str, object]):
    """The family whose kernel patterns match a device kernel's name."""
    for fam, mod in fams.items():
        if any(re.search(pat, name) for pat in mod.KERNELS):
            return fam
    return None


class Counter:
    """Needed bytes per family while installed."""

    def __init__(self, fams: Dict[str, object]):
        self.fams = fams
        self.parts: Dict[str, List] = {f: [] for f in fams}
        self._saved: List[Tuple[object, str, object]] = []

    def install(self) -> None:
        for fam, mod in self.fams.items():
            for (modname, attr), fn_name in mod.HOOKS.items():
                target = importlib.import_module(modname)
                original = getattr(target, attr)
                count = getattr(mod, fn_name)
                self._saved.append((target, attr, original))
                setattr(target, attr, self._wrap(fam, original, count))

    def uninstall(self) -> None:
        for target, attr, original in reversed(self._saved):
            setattr(target, attr, original)
        self._saved.clear()

    def _wrap(self, fam, original, count):
        def counted(*args, **kwargs):
            result = original(*args, **kwargs)
            self.parts[fam].append(count(result, *args, **kwargs))
            return result
        return counted

    def totals(self) -> Dict[str, int]:
        """Bytes per family while installed."""
        return {fam: int(sum(int(p) if not isinstance(p, torch.Tensor)
                             else p.long() for p in parts)) if parts else 0
                for fam, parts in self.parts.items()}
