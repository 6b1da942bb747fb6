"""The reference's re-exports at the port's counterpart paths.

A user imports these names from the reference module's path
(``from repro.core.batch import insert_edges_ref``); the port's module at
the same path serves the port's own object, the one its defining module
holds, and a constant there equals the reference's (the key sentinels as
the uint32 ids the port keeps as int32 bit patterns).  These are the
names ``tests/test_torch_surface.py`` counts as surface: those in a
reference module's ``__all__`` or its ``REEXPORTS``, and the constants a
reference module defines that the port keeps in one place."""
import importlib
import numbers

import numpy as np
import pytest

#: (module under both packages, name, the port module that defines it)
REEXPORTS = [
    ("algorithms.bfs", "INF", "algorithms.sssp"),
    ("algorithms.bfs", "expand_vertices", "core.worklist"),
    ("algorithms.bfs", "relax_edges", "algorithms.sssp"),
    ("algorithms.pagerank", "SLAB_WIDTH", "core.hashing"),
    ("algorithms.pagerank", "pool_edges", "core.worklist"),
    ("algorithms.wcc", "updated_lane_mask", "core.worklist"),
    ("core.batch", "delete_edges_ref", "kernels.slab_update.ref"),
    ("core.batch", "insert_edges_ref", "kernels.slab_update.ref"),
    ("core.batch", "query_edges_ref", "kernels.slab_update.ref"),
    ("core.batch", "sort_by_bucket", "kernels.slab_update.ref"),
    ("kernels.flash_attention.kernel", "NEG_INF",
     "kernels.flash_attention.chunked"),
    ("kernels.slab_compact.ops", "chain_order", "kernels.slab_compact.ref"),
    ("kernels.slab_intersect.ops", "is_valid_vertex", "core.hashing"),
    ("kernels.slab_intersect.ops", "probe", "kernels.slab_update.ref"),
    ("kernels.slab_intersect.ops", "probe_hits_ref",
     "kernels.slab_intersect.ref"),
    ("kernels.slab_intersect.ops", "search_edges_ref",
     "kernels.slab_intersect.ref"),
    ("kernels.slab_sweep.ops", "slab_sweep_ref", "kernels.slab_sweep.ref"),
    ("kernels.slab_update", "IMPLS", "core.device"),
    ("kernels.slab_update.ops", "IMPLS", "core.device"),
    ("kernels.slab_update.ops", "delete_edges_ref", "kernels.slab_update.ref"),
    ("kernels.slab_update.ops", "insert_edges_ref", "kernels.slab_update.ref"),
    ("kernels.slab_update.ops", "query_edges_ref", "kernels.slab_update.ref"),
    ("kernels.slab_update.ops", "probe", "kernels.slab_update.ref"),
    ("models.gnn.tensor_field", "clebsch_gordan_real", "models.gnn.irreps"),
    ("resilience.guard", "EMPTY_KEY", "core.hashing"),
    ("resilience.guard", "INVALID_VERTEX", "core.hashing"),
    ("resilience.guard", "TOMBSTONE_KEY", "core.hashing"),
    ("resilience.invariants", "TOMBSTONE_KEY", "core.hashing"),
]

#: names whose values differ by design: the implementations each package
#: can run (the reference's "pallas"/"jnp", the port's "cuda"/"torch")
VALUE_DEPARTS = {"IMPLS"}


@pytest.mark.parametrize("path,name,home", REEXPORTS,
                         ids=[f"{p}.{n}" for p, n, _ in REEXPORTS])
def test_reexport_is_the_ports_own(path, name, home):
    port = importlib.import_module(f"repro_torch.{path}")
    ref = importlib.import_module(f"repro.{path}")
    got = getattr(port, name)
    assert got is getattr(importlib.import_module(f"repro_torch.{home}"),
                          name)
    want = getattr(ref, name)
    if name in VALUE_DEPARTS or callable(want):
        assert callable(got) == callable(want)
        return
    if isinstance(want, numbers.Number) or hasattr(want, "dtype"):
        if name.endswith(("_KEY", "_SLAB", "_VERTEX")):
            assert int(got) & 0xFFFFFFFF == int(want) & 0xFFFFFFFF
        else:
            # the reference's jnp scalars are float32 where the port keeps
            # a Python float: the same float32 value
            assert np.float32(got) == np.float32(want)
    else:
        assert got == want


def test_clebsch_gordan_real_equal_reference():
    from repro.models.gnn import tensor_field as jtf
    from repro_torch.models.gnn import tensor_field as ttf
    for ls in ((1, 1, 1), (1, 1, 2), (2, 1, 1)):
        np.testing.assert_array_equal(
            np.asarray(ttf.clebsch_gordan_real(*ls)),
            np.asarray(jtf.clebsch_gordan_real(*ls)))


def test_semiring_identity_equal_reference():
    import torch
    from repro.kernels.slab_sweep import kernel as jk
    # the port defines it in the plain version's module
    from repro_torch.kernels.slab_sweep import ref as tk
    for semiring in ("sum", "min", "min_plus", "arg_min_plus"):
        for jd, td in ((np.float32, torch.float32),
                       (np.int32, torch.int32)):
            got = tk.semiring_identity(semiring, td)
            want = jk.semiring_identity(semiring, jd)
            assert float(got) == float(np.asarray(want))
