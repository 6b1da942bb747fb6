"""Per-layer metrics: one reader a metric,
``gpubench/layer_metrics/<name>.py``,
each with ``read(traced) -> float | None`` (None: nothing to read, and the
metric is left out of the line)."""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional

from .devtrace import DeviceTrace
from .spans import Span

#: one H100 SXM's HBM3 bandwidth, NVIDIA's data sheet (bytes/s)
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Traced:
    """What a traced window saw."""
    rounds: int                      # rounds completed in the window
    window_s: float                  # the traced stretch: the window's start
                                     # to the end of its first traced rounds
    spans: List[Span]
    launches: Dict[str, int]         # kernel launches in the window
    device: Optional[DeviceTrace]    # None without a card
    family_ns: Dict[str, int]        # device time per work family (stretch)
    family_bytes: Dict[str, int]     # needed bytes per work family (stretch)
    peak_bytes_per_s: float = HBM_BYTES_PER_S


def roofline(t: Traced, fams) -> Optional[float]:
    """Needed bytes of ``fams`` over their device time, as a share of the
    HBM rate (%); None where none of them ran or none was counted."""
    ns = sum(t.family_ns.get(f, 0) for f in fams)
    nbytes = sum(t.family_bytes.get(f, 0) for f in fams)
    if t.device is None or ns <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / (ns * 1e-9) / t.peak_bytes_per_s


def mean_ms(spans: List[Span]) -> Optional[float]:
    return sum(s.ms for s in spans) / len(spans) if spans else None


def load(root: Path, name: str):
    path = root / "gpubench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_layer_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
