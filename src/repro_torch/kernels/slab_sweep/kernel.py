"""The semiring slab-sweep kernel (``csrc/slab_sweep.cu``) and its wrapper.

On CUDA tensors ``slab_sweep`` launches the hand-written kernel; on CPU
tensors it runs the plain version ``ref.slab_sweep_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.hashing import SLAB_WIDTH
from .. import runtime
from .ref import SEMIRINGS, slab_sweep_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_VALUE_KIND = {torch.float32: 0, torch.int32: 1}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("slab_sweep")
    if lib.slab_sweep.argtypes is None:
        lib.slab_sweep.argtypes = [_I, _I] + [_P] * 7 + [_I, ctypes.c_uint,
                                                          _P]
        lib.slab_sweep.restype = _I
        lib.slab_sweep_error_string.argtypes = [_I]
        lib.slab_sweep_error_string.restype = ctypes.c_char_p
    return lib


def slab_sweep(keys: torch.Tensor, slab_vertex: torch.Tensor,
               values: torch.Tensor, weights: Optional[torch.Tensor] = None,
               frontier: Optional[torch.Tensor] = None,
               target: Optional[torch.Tensor] = None, *, semiring: str,
               n_vertices: int) -> torch.Tensor:
    """(S,) semiring partials of the pool rows (see ``ref.slab_sweep_ref``).

    ``keys`` (S, 128) int32, ``slab_vertex`` (S,) int32, ``values`` (V,)
    float32 or int32 with ``V >= n_vertices``, ``weights`` (S, 128) float32
    (float values only), ``frontier`` (V,) bool, ``target`` (S,) of the
    values' dtype for ``arg_min_plus``.

    The rows must be packed, as every engine path keeps them: in each row,
    every lane after the first EMPTY lane is EMPTY.  The kernel reads a row
    only up to its first EMPTY lane; the plain version reads every lane, so
    the two agree on packed pools.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if semiring == "arg_min_plus" and target is None:
        raise ValueError("arg_min_plus requires a per-slab target")
    if weights is not None and not values.dtype.is_floating_point:
        raise ValueError("integer values take no weights")
    if not keys.is_cuda:
        return slab_sweep_ref(keys, slab_vertex, values, semiring=semiring,
                              n_vertices=n_vertices, weights=weights,
                              frontier=frontier, target=target)
    dev = keys.device
    S = keys.shape[0]
    if values.dtype not in _VALUE_KIND:
        raise ValueError(f"values must be float32 or int32, not "
                         f"{values.dtype}")
    if not 0 <= n_vertices <= values.numel():
        raise ValueError(f"n_vertices={n_vertices} outside the "
                         f"{values.numel()} values")
    runtime.require(keys, "keys", torch.int32, dev, (S, SLAB_WIDTH), 16)
    runtime.require(slab_vertex, "slab_vertex", torch.int32, dev, (S,))
    runtime.require(values, "values", values.dtype, dev, (values.numel(),))
    if weights is not None:
        runtime.require(weights, "weights", torch.float32, dev,
                        (S, SLAB_WIDTH), 16)
    if frontier is not None:
        if frontier.dtype != torch.bool:
            frontier = frontier != 0
        if frontier.numel() < n_vertices:
            raise ValueError("frontier shorter than n_vertices")
        runtime.require(frontier, "frontier", torch.bool, dev,
                        (frontier.numel(),), 1)
    if semiring == "arg_min_plus":
        runtime.require(target, "target", values.dtype, dev, (S,))
    else:
        target = None
    out = torch.empty(S, device=dev, dtype=(
        torch.int32 if semiring == "arg_min_plus" else values.dtype))
    lib = _lib()
    rc = lib.slab_sweep(SEMIRINGS.index(semiring), _VALUE_KIND[values.dtype],
                        keys.data_ptr(), slab_vertex.data_ptr(),
                        values.data_ptr(), runtime.ptr(weights),
                        runtime.ptr(frontier), runtime.ptr(target),
                        out.data_ptr(), S, n_vertices,
                        runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "slab_sweep_error_string", "slab_sweep")
    runtime.LAUNCHES["slab_sweep"] += 1
    return out
