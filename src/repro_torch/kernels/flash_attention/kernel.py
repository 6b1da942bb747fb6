"""The flash-attention kernel of ``csrc/flash_attention.cu`` and its ctypes
binding.

``flash_attention_cuda`` launches the blocked online-softmax forward on CUDA
tensors: bfloat16 ones on the tensor cores (``wgmma``), float32 ones on the
CUDA cores in exact float32; both are one library and one entry point.  Its
plain version is ``ref.attention_ref``, which ``ops`` runs for CPU tensors
and the tests hold the kernel to.
"""
from __future__ import annotations

import ctypes

import torch

from .. import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = [_P] * 4 + [_I] * 10 + [_F, _F, _P]
        lib.flash_attention.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, softcap: float,
                         sm_scale: float, kv_len: int) -> torch.Tensor:
    """q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), contiguous CUDA tensors of
    one dtype (float32 or bfloat16), D in ``HEAD_DIMS``, Hq a multiple of
    Hkv -> (B, Hq, Sq, D) in q's dtype."""
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Hq, Sq, D), got {tuple(q.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} "
                         "KV heads")
    runtime.require(q, "q", q.dtype, dev, (B, Hq, Sq, D), 16)
    runtime.require(k, "k", q.dtype, dev, (B, Hkv, Skv, D), 16)
    runtime.require(v, "v", q.dtype, dev, (B, Hkv, Skv, D), 16)
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        Sq, Skv, D, _DTYPES[q.dtype], int(bool(causal)), int(window),
        int(min(kv_len, Skv)), float(softcap), float(sm_scale),
        runtime.stream_handle(dev))
    runtime.check_launch(rc, lib, "flash_attention_error_string",
                         "flash_attention")
    runtime.LAUNCHES["flash_attention"] += 1
    return out
