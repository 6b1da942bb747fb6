"""Kernels (``csrc/slab_sweep.cu``, ``csrc/slab_pagerank.cu``): the sweeps'
needed bytes over their device time, as a share of the HBM rate."""
from gpubench.harness.layers import roofline


def read(t):
    return roofline(t, ("sweep", "contrib_sums"))
