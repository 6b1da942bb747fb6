"""The EmbeddingBag kernel of ``csrc/embedding_bag.cu`` and its ctypes
binding; its plain version is ``ref.embedding_bag_ref``."""
from __future__ import annotations

import ctypes

import torch

from .. import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("embedding_bag")
    if lib.embedding_bag.argtypes is None:
        lib.embedding_bag.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.embedding_bag.restype = _I
        lib.embedding_bag_error_string.argtypes = [_I]
        lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def embedding_bag_cuda(indices: torch.Tensor, weights: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """indices (B, L) int32 (-1 pads; an index outside [0, N) reads as a
    pad), weights (B, L) float32, table (N, D) float32 or bfloat16, all
    contiguous on one card -> (B, D) in the table's dtype."""
    dev = table.device
    if table.dtype not in _DTYPES:
        raise ValueError(f"embedding_bag takes a float32 or bfloat16 table, "
                         f"not {table.dtype}")
    if indices.dim() != 2 or table.dim() != 2:
        raise ValueError("indices must be (B, L) and table (N, D)")
    (B, L), (N, D) = indices.shape, table.shape
    runtime.require(indices, "indices", torch.int32, dev, (B, L))
    runtime.require(weights, "weights", torch.float32, dev, (B, L))
    runtime.require(table, "table", table.dtype, dev, (N, D))
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    lib = _lib()
    rc = lib.embedding_bag(indices.data_ptr(), weights.data_ptr(),
                           table.data_ptr(), out.data_ptr(), B, L, N, D,
                           _DTYPES[table.dtype], runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "embedding_bag_error_string",
                         "embedding_bag")
    runtime.LAUNCHES["embedding_bag"] += 1
    return out
