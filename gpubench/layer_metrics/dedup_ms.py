"""Store (``stream/store.py``): the mean ``store.apply.host_dedup`` span,
the host's canonicalisation of a batch."""
from gpubench.harness.layers import mean_ms
from gpubench.harness.spans import closed


def read(t):
    return mean_ms(closed(t.spans, "store.apply.host_dedup"))
