"""The flash-attention kernels of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` and their ctypes bindings.

``flash_attention_cuda`` launches the blocked online-softmax forward on CUDA
tensors: bfloat16 ones on the tensor cores (``wgmma``), float32 ones on the
CUDA cores in exact float32; both are one library and one entry point.
Asked for ``lse``, it also returns each row's log-sum-exp, which
``flash_attention_bwd_cuda`` (the backward: dq, dk, dv, deterministic;
bfloat16 on the tensor cores, float32 on the CUDA cores) recomputes the
softmax from.  The backward's dK/dV pass walks a work list that
``schedule.bwd_work_list`` builds on the host, once a shape (cached here
on the device), with a float32 workspace for the partials of shared key
tiles that the wrapper allocates each call.
Their plain versions are ``ref.attention_ref``, ``ref.attention_lse_ref``
and ``ref.attention_bwd_ref``, which the tests hold the kernels to.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import torch

from .. import runtime
from .chunked import NEG_INF
from .schedule import bwd_work_list

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: head dims the kernels are instantiated for
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the backward's dK/dV key tile (and its units' query tile) per dtype
BWD_KEY_TILES = {torch.float32: 32, torch.bfloat16: 64}
#: work lists kept on the device, by shape, masks and dtype
_PLANS: Dict[tuple, tuple] = {}
_MAX_PLANS = 64


def _lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = [_P] * 4 + [_I] * 10 + [_F, _F, _P, _P]
        lib.flash_attention.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        lib.flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 10 \
            + [_F, _F, _P] + [_P, _I, _P, _P, _P, _I, _P]
        lib.flash_attention_bwd.restype = _I
        lib.flash_attention_bwd_error_string.argtypes = [_I]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, Hq, Hkv, Sq, Skv, D) of q (B, Hq, Sq, D), k and v (B, Hkv, Skv,
    D), after checking what the kernels take."""
    dev = q.device
    if not q.is_cuda:
        raise ValueError("kernel 10 takes CUDA tensors, not tensors on "
                         f"{dev}")
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
    return B, Hq, Hkv, Sq, Skv, D


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, softcap: float,
                         sm_scale: float, kv_len: int, lse: bool = False
                         ) -> Union[torch.Tensor,
                                    Tuple[torch.Tensor, torch.Tensor]]:
    """q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), contiguous CUDA tensors of
    one dtype (float32 or bfloat16), D in ``HEAD_DIMS``, Hq a multiple of
    Hkv -> (B, Hq, Sq, D) in q's dtype; with ``lse``, also the rows'
    log-sum-exp (B, Hq, Sq) float32 (+inf for a row with no visible key)."""
    B, Hq, Hkv, Sq, Skv, D = _check_shapes(q, k, v)
    out = torch.empty_like(q)
    row_lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                          device=q.device) if lse else None
    lib = _lib()
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        Sq, Skv, D, _DTYPES[q.dtype], int(bool(causal)), int(window),
        int(min(kv_len, Skv)), float(softcap), float(sm_scale),
        runtime.stream_handle(q.device), runtime.ptr(row_lse))
    runtime.check_launch(rc, lib, "flash_attention_error_string",
                         "flash_attention")
    runtime.LAUNCHES["flash_attention"] += 1
    return (out, row_lse) if lse else out


def _bwd_plan(dev: torch.device, dtype: torch.dtype, B: int, Hq: int,
              Hkv: int, Sq: int, Skv: int, causal: bool, window: int,
              kv_len: int) -> tuple:
    """(items, red_tiles, red_ptr, red_slots) int32 on ``dev`` and the
    workspace's slots, for this shape on ``dev``'s SM count."""
    key = (dev, dtype, B, Hq, Hkv, Sq, Skv, causal, window, kv_len)
    plan = _PLANS.get(key)
    if plan is None:
        tile = BWD_KEY_TILES[dtype]
        wl = bwd_work_list(
            B, Hq, Hkv, Sq, Skv, causal=causal, window=window,
            kv_len=kv_len, key_tile=tile, query_tile=tile,
            n_sm=torch.cuda.get_device_properties(dev).multi_processor_count)
        plan = tuple(torch.from_numpy(a).to(dev) for a in (
            wl.items, wl.red_tiles, wl.red_ptr, wl.red_slots)) \
            + (wl.n_slots,)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    return plan


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool, window: int, softcap: float,
                             sm_scale: float, kv_len: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward of ``flash_attention_cuda`` from its inputs, its output
    ``o`` and row log-sum-exp ``lse`` and the output's gradient ``do`` (all
    contiguous CUDA tensors; o and do of q's shape and dtype, lse (B, Hq,
    Sq) float32) -> (dq, dk, dv) in the inputs' dtype, bit-reproducible (no
    atomics).  Allocates the dK/dV partials' float32 workspace, 2 x key
    tile x D floats a slot of the work list."""
    B, Hq, Hkv, Sq, Skv, D = _check_shapes(q, k, v)
    dev = q.device
    runtime.require(o, "o", q.dtype, dev, (B, Hq, Sq, D), 16)
    runtime.require(do, "do", q.dtype, dev, (B, Hq, Sq, D), 16)
    runtime.require(lse, "lse", torch.float32, dev, (B, Hq, Sq))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    kv_len = int(min(kv_len, Skv))
    items, red_tiles, red_ptr, red_slots, n_slots = _bwd_plan(
        dev, q.dtype, B, Hq, Hkv, Sq, Skv, bool(causal), int(window), kv_len)
    ws = torch.empty((n_slots, 2, BWD_KEY_TILES[q.dtype], D),
                     dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
        _DTYPES[q.dtype], int(bool(causal)), int(window), kv_len,
        float(softcap), float(sm_scale), runtime.stream_handle(dev),
        items.data_ptr(), items.shape[0], red_tiles.data_ptr(),
        red_ptr.data_ptr(), red_slots.data_ptr(), red_tiles.shape[0],
        ws.data_ptr())
    runtime.check_launch(rc, lib, "flash_attention_bwd_error_string",
                         "flash_attention_bwd")
    runtime.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
