"""Property kind ``wcc``: the program's weak-components stream property,
and its check against the plain reference.  ``wcc_wrong`` counts served
labels that differ from the least vertex id of the component."""
from gpubench.reference.wcc import components, label_errors

NUMBERS = {"wcc_wrong": 0}


def spec(p, ctx):
    from repro_torch.algorithms import wcc_stream_property
    return wcc_stream_property()


def check(p, keys, V, value, out):
    out["wcc_wrong"] += label_errors(value, components(keys, V))
