"""PageRank's pool sweep: the sum semiring of ``kernels/slab_sweep`` with no
frontier (the paper's Compute kernel, Alg. 14)."""
from .ops import slab_contrib_sums, slab_contrib_sums_ref

__all__ = ["slab_contrib_sums", "slab_contrib_sums_ref"]
