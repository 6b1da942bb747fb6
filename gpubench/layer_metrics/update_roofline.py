"""Kernels (``csrc/slab_update.cu``, ``csrc/slab_compact.cu``): the probe's,
the commit's and compaction's needed bytes over their device time, as a
share of the HBM rate."""
from gpubench.harness.layers import roofline


def read(t):
    return roofline(t, ("probe", "commit", "compaction"))
