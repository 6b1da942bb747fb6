"""PageRank's pool sweep (kernel 4, the reference's
``slab_contrib_sums_pallas``): per slab row, the sum of ``contrib[key]``
over every lane whose key is a vertex, the ``sum`` semiring of the slab
sweep with no frontier.  Its own kernel, ``csrc/slab_pagerank.cu``, reads
every lane as the reference does, so any pool is exact."""
from .kernel import slab_contrib_sums_cuda
from .ops import slab_contrib_sums
from .ref import slab_contrib_sums_ref

__all__ = ["slab_contrib_sums", "slab_contrib_sums_cuda",
           "slab_contrib_sums_ref"]
