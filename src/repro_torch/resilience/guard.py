"""Admission validation of raw update batches.

Runs before ``canonical_batch``'s uint32 casts could wrap a negative id or
truncate a float.  A bad batch raises :class:`QuarantinedBatch` with
structured per-field reasons; the store has not moved.  ``src`` ids index
bucket layouts and must be ``< n_vertices``; ``dst`` ids may exceed
``n_vertices`` but must not collide with the reserved key sentinels.
"""
from __future__ import annotations

from typing import List

import numpy as np

#: dst ids the update plane reserves (uint32 key sentinels)
_SENTINELS = (0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF)


class QuarantinedBatch(Exception):
    """An update batch rejected at admission.  ``reasons`` is a list of
    ``{"field", "reason", "count", "example"}`` dicts."""

    def __init__(self, reasons: List[dict]):
        self.reasons = reasons
        bits = "; ".join(f"{r['field']}: {r['reason']} x{r['count']}"
                         for r in reasons)
        super().__init__(f"batch quarantined - {bits}")


def _check_ids(reasons: List[dict], field: str, raw, *, n_vertices: int,
               is_src: bool) -> None:
    a = np.asarray(() if raw is None else raw)
    if a.size == 0:
        return
    if a.dtype.kind == "f":
        bad = ~np.isfinite(a)
        if bad.any():
            reasons.append({"field": field, "reason": "non-finite id",
                            "count": int(bad.sum()),
                            "example": float(a[bad][0])})
            return
    elif a.dtype.kind not in "iub":
        reasons.append({"field": field, "reason": "non-numeric dtype",
                        "count": int(a.size), "example": str(a.dtype)})
        return
    a = a.astype(np.int64)
    neg = a < 0
    if neg.any():
        reasons.append({"field": field, "reason": "negative id",
                        "count": int(neg.sum()), "example": int(a[neg][0])})
        return
    if is_src:
        bad = a >= n_vertices
        reason = f"src >= n_vertices ({n_vertices})"
    else:
        bad = (a > 0xFFFFFFFF) | np.isin(a, _SENTINELS)
        reason = "reserved/overflowing dst key"
    if bad.any():
        reasons.append({"field": field, "reason": reason,
                        "count": int(bad.sum()), "example": int(a[bad][0])})


def validate_batch(ins_src, ins_dst, ins_w, del_src, del_dst, *,
                   n_vertices: int) -> None:
    """Raise :class:`QuarantinedBatch` on mismatched halves, non-finite or
    negative ids, src outside the vertex range, dst on a key sentinel, or
    non-finite weights.  An accepted batch passes through untouched."""
    reasons: List[dict] = []
    n_ins = len(np.asarray(() if ins_src is None else ins_src))
    n_ind = len(np.asarray(() if ins_dst is None else ins_dst))
    n_del = len(np.asarray(() if del_src is None else del_src))
    n_dd = len(np.asarray(() if del_dst is None else del_dst))
    if n_ins != n_ind:
        reasons.append({"field": "ins", "reason":
                        f"src/dst length mismatch ({n_ins} vs {n_ind})",
                        "count": 1, "example": None})
    if n_del != n_dd:
        reasons.append({"field": "del", "reason":
                        f"src/dst length mismatch ({n_del} vs {n_dd})",
                        "count": 1, "example": None})
    if ins_w is not None:
        w = np.asarray(ins_w)
        if len(w) != n_ins:
            reasons.append({"field": "ins_w", "reason":
                            f"weight length mismatch ({len(w)} vs {n_ins})",
                            "count": 1, "example": None})
        elif w.size:
            bad = ~np.isfinite(w.astype(np.float64, copy=False))
            if bad.any():
                reasons.append({"field": "ins_w",
                                "reason": "non-finite weight",
                                "count": int(bad.sum()),
                                "example": float(w[bad][0])})
    if not reasons:
        for field, raw, is_src in (("ins_src", ins_src, True),
                                   ("ins_dst", ins_dst, False),
                                   ("del_src", del_src, True),
                                   ("del_dst", del_dst, False)):
            _check_ids(reasons, field, raw, n_vertices=n_vertices,
                       is_src=is_src)
    if reasons:
        raise QuarantinedBatch(reasons)
