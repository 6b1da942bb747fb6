"""Engines (``core/``, ``kernels/*/ops.py``): the program's kernel
launches a round, from ``kernels.runtime.LAUNCHES``."""


def read(t):
    if t.rounds <= 0:
        return None
    return sum(t.launches.values()) / t.rounds
