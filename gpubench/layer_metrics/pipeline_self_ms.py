"""Request pipeline (``stream/requests.py``): the mean time of an update
request outside the store's apply, from the ``pipeline.update`` span less
the ``store.apply`` spans inside it (the wait for the device included)."""
from gpubench.harness.spans import closed


def read(t):
    spans = t.spans
    updates = closed(spans, "pipeline.update")
    if not updates:
        return None
    inside = {}
    for s in closed(spans, "store.apply"):
        p = s.parent
        while p is not None and spans[p].name != "pipeline.update":
            p = spans[p].parent
        if p is not None:
            inside[p] = inside.get(p, 0.0) + s.ms
    index = {id(s): i for i, s in enumerate(spans)}
    return sum(u.ms - inside.get(index[id(u)], 0.0)
               for u in updates) / len(updates)
