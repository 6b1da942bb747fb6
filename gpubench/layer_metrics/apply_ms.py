"""Store (``stream/store.py``): the mean ``store.apply`` span, from the
admission of a batch to its closed epoch and the maintenance check."""
from gpubench.harness.layers import mean_ms
from gpubench.harness.spans import closed


def read(t):
    return mean_ms(closed(t.spans, "store.apply"))
