"""Device: the share of the traced stretch (the window's first traced
rounds) in which nothing ran on the card (kernels, copies and sets from
the profiler's device trace)."""


def read(t):
    if t.device is None:
        return None
    return 100.0 * (1.0 - t.device.busy_ns() * 1e-9 / t.window_s)
