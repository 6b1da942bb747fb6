"""Semiring slab sweep: the CUDA kernel, its plain version and the
SlabGraph-level engine (``ops``)."""
from .kernel import slab_sweep
from .ops import sweep_partials, sweep_vertices
from .ref import INT32_MAX, SEMIRINGS, semiring_identity, slab_sweep_ref

__all__ = ["slab_sweep", "sweep_partials", "sweep_vertices", "INT32_MAX",
           "SEMIRINGS", "semiring_identity", "slab_sweep_ref"]
