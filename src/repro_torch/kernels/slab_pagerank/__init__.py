"""PageRank's pool sweep (kernel 4, the reference's
``slab_contrib_sums_pallas``): the ``sum`` semiring of the slab-sweep
kernel with no frontier, as its own named entry point.  No kernel of its
own: ``kernel`` checks the rows and launches kernel 3's ``sum``."""
from .kernel import slab_contrib_sums_cuda, unpacked_rows
from .ops import slab_contrib_sums
from .ref import slab_contrib_sums_ref

__all__ = ["slab_contrib_sums", "slab_contrib_sums_cuda",
           "slab_contrib_sums_ref", "unpacked_rows"]
