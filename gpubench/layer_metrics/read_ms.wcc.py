"""Registry and algorithms (``stream/properties.py``, ``algorithms/*``):
the mean ``pipeline.property`` span of the ``wcc`` reads, its catch-up
and the wait for the device included."""
from gpubench.harness.layers import mean_ms
from gpubench.harness.spans import closed


def read(t):
    return mean_ms([s for s in closed(t.spans, "pipeline.property")
                    if s.args.get("prop") == "wcc"])
