"""Helpers shared by the port's parity tests: carry SlabGraph state between
the JAX reference and the PyTorch port as numpy, and compare it."""
import jax
import numpy as np
import torch

from repro_torch.core.bridge import slab_graph_from_numpy, \
    slab_graph_to_numpy
from repro_torch.core.slab_graph import FIELDS

CPU = torch.device("cpu")


def jax_fields(g) -> dict:
    """One numpy array per field of a reference SlabGraph (keys as int32
    bit patterns, as the port keeps them)."""
    out = {}
    for name in FIELDS:
        a = getattr(g, name)
        if a is None:
            out[name] = None
            continue
        a = np.asarray(a)
        out[name] = a.view(np.int32) if a.dtype == np.uint32 else a
    return out


def to_port(g_jax):
    """The reference graph's state as a port SlabGraph on the CPU."""
    return slab_graph_from_numpy(jax_fields(g_jax), CPU)


def assert_pools_equal(g_torch, g_jax, what=""):
    """Leaf-for-leaf equality of a port graph and a reference graph."""
    want = jax_fields(g_jax)
    got = slab_graph_to_numpy(g_torch)
    assert g_torch.n_vertices == g_jax.n_vertices
    assert g_torch.n_buckets == g_jax.n_buckets
    assert g_torch.weighted == g_jax.weighted
    for name in FIELDS:
        if want[name] is None:
            assert got[name] is None, f"{what}: {name}"
            continue
        assert got[name].shape == want[name].shape, f"{what}: {name} shape"
        assert got[name].dtype == want[name].dtype, f"{what}: {name} dtype"
        assert np.array_equal(got[name], want[name]), f"{what}: {name}"


def ids(a, n=None) -> torch.Tensor:
    """Host ids (uint32 values) as an int32 bit-pattern tensor padded with
    INVALID_VERTEX to ``n`` lanes."""
    a = np.asarray(a, dtype=np.int64).astype(np.uint32)
    n = len(a) if n is None else n
    out = np.full(n, 0xFFFFFFFF, np.uint32)
    out[:len(a)] = a
    return torch.from_numpy(out.view(np.int32).copy())


def jids(a, n=None):
    """The same padded batch as a uint32 JAX array."""
    return jax.numpy.asarray(ids(a, n).numpy().view(np.uint32))


def np_of(t) -> np.ndarray:
    """A port tensor or reference array as numpy (uint32 viewed as int32)."""
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_vectors_equal(t, j, what=""):
    """Bit-identical vectors (WCC parents and labels, plan outputs)."""
    got, want = np_of(t), np_of(j)
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} {want.dtype}"
    assert np.array_equal(got, want), what


def assert_reports_equal(rep_t, rep_j, what=""):
    """A port CompactionReport equals the reference's: the slab map and the
    five counts."""
    assert_vectors_equal(rep_t.perm, rep_j.perm, f"{what}: perm")
    for name in ("live_lanes", "live_slabs", "old_capacity", "new_capacity",
                 "old_next_free", "new_next_free"):
        assert getattr(rep_t, name) == getattr(rep_j, name), \
            f"{what}: {name}"


def assert_maintenance_equal(store_t, store_j, what=""):
    """The two stores' maintenance counters and per-pass events agree
    (durations aside)."""
    for name in ("version", "maintenance_count", "_epochs_since_maint",
                 "_deletes_since_maint", "_tombstone_base", "_last_reserve"):
        assert getattr(store_t, name) == getattr(store_j, name), \
            f"{what}: {name}"

    def events(store):
        return [{k: v for k, v in e.items() if k != "duration_s"}
                for e in store.maintenance_events]

    assert events(store_t) == events(store_j), f"{what}: maintenance events"
