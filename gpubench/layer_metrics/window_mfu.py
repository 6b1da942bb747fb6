"""Device: the traced stretch's share of the card's peak.  Bytes bound
every counted operation, so the peak is the HBM rate: the needed bytes of
every counted operation of the stretch's rounds over its seconds at that
rate."""


def read(t):
    if t.device is None:
        return None
    total = sum(t.family_bytes.values())
    return 100.0 * total / (t.window_s * t.peak_bytes_per_s)
