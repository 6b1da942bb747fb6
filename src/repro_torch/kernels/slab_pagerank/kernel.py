"""Kernel 4 (``csrc/slab_pagerank.cu``) and its ctypes binding: per slab
row, the sum of ``contrib[key]`` over every lane whose key is a vertex.

On CUDA tensors ``slab_contrib_sums_cuda`` launches the hand-written kernel,
which reads every lane of every allocated row, packed or not, as the
reference does; on CPU tensors it runs the plain version
``ref.slab_contrib_sums_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.hashing import SLAB_WIDTH
from .. import runtime
from .ref import slab_contrib_sums_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = runtime.library("slab_pagerank")
    if lib.slab_contrib_sums.argtypes is None:
        lib.slab_contrib_sums.argtypes = [_P] * 4 + [_I, ctypes.c_uint, _P]
        lib.slab_contrib_sums.restype = _I
        lib.slab_contrib_sums_error_string.argtypes = [_I]
        lib.slab_contrib_sums_error_string.restype = ctypes.c_char_p
    return lib


def slab_contrib_sums_cuda(keys: torch.Tensor, slab_vertex: torch.Tensor,
                           contrib: torch.Tensor, *,
                           n_vertices: int) -> torch.Tensor:
    """keys (S, 128) int32 bit patterns, slab_vertex (S,) int32, contrib
    (V,) float32 with ``V >= n_vertices`` -> (S,) float32: for each row
    whose owner is >= 0 the sum of ``contrib[key]`` over every lane whose
    key, read as uint32, is below ``n_vertices``; 0 for the other rows."""
    if not keys.is_cuda:
        return slab_contrib_sums_ref(keys, slab_vertex, contrib,
                                     n_vertices=n_vertices)
    dev = keys.device
    S = keys.shape[0]
    if not 0 <= n_vertices <= contrib.numel():
        raise ValueError(f"n_vertices={n_vertices} outside the "
                         f"{contrib.numel()} contributions")
    runtime.require(keys, "keys", torch.int32, dev, (S, SLAB_WIDTH), 16)
    runtime.require(slab_vertex, "slab_vertex", torch.int32, dev, (S,))
    runtime.require(contrib, "contrib", torch.float32, dev,
                    (contrib.numel(),))
    out = torch.empty(S, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.slab_contrib_sums(keys.data_ptr(), slab_vertex.data_ptr(),
                               contrib.data_ptr(), out.data_ptr(), S,
                               n_vertices, runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_contrib_sums_error_string",
                         "slab_contrib_sums")
    runtime.LAUNCHES["slab_contrib_sums"] += 1
    return out
