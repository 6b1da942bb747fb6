"""Property kind ``pagerank``: the program's PageRank stream property, and
its check against the plain reference.

``pagerank_l1`` is the widest L1 distance, over the checked rounds, of the
served vector from the reference's float64 power iteration run to 1e-12;
``pagerank_dtype_wrong`` counts served vectors in another dtype than the
configuration states.  The control is the reference in the precision
below that dtype, at the configuration's error margin and iteration cap.
"""
import torch

from gpubench.reference.pagerank import pagerank, pagerank_l1

#: the precision below each stated one, for the control
LOWER = {"float64": "float32", "float32": "bfloat16"}

NUMBERS = {"pagerank_l1": 0.0, "pagerank_dtype_wrong": 0}


def spec(p, ctx):
    from repro_torch.algorithms import pagerank_stream_property
    return pagerank_stream_property(damping=p["damping"],
                                    error_margin=p["error_margin"],
                                    max_iter=p["max_iter"])


def check(p, keys, V, value, out):
    if value.dtype != getattr(torch, p["dtype"]):
        out["pagerank_dtype_wrong"] += 1
    want = pagerank(keys, V, damping=p["damping"], tol=1e-12, max_iter=2000)
    out["pagerank_l1"] = max(out["pagerank_l1"], pagerank_l1(value, want))


def control(p, keys, V):
    """The reference in the program's place, one precision below."""
    return pagerank(keys, V, damping=p["damping"], tol=p["error_margin"],
                    max_iter=p["max_iter"],
                    dtype=getattr(torch, LOWER[p["dtype"]])).to(
                        getattr(torch, p["dtype"]))
