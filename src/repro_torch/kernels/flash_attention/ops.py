"""The public flash-attention op, from
``repro.kernels.flash_attention.ops.flash_attention``.

``impl="auto"`` launches the hand-written kernels for CUDA tensors and runs
the plain ``attention_ref`` for CPU tensors (``core.device.resolve_impl``).
On CUDA tensors the op is the registered operator
``repro_torch::flash_attention_fwd``: the forward kernel with its row
log-sum-exp, whose autograd formula is the registered operator
``repro_torch::flash_attention_bwd``, the backward kernel.  Both have a
fake implementation (output shapes, no launch) and a flop formula
(``attention_flops``), so a trace under ``FakeTensorMode`` and
``FlopCounterMode`` of a step on CUDA tensors (``launch.dryrun``'s
``attn_impl="kernel"``) holds the two operators the card runs.  There is
no path from CUDA tensors to the plain version: a kernel that does not
build or launch raises, and the kernels' wrappers refuse CPU tensors.  On CPU
tensors ``attention_ref``'s own autograd gives the gradient, as
``jax.grad`` of the reference's ``attention_ref`` does (the reference's
Pallas kernel has no VJP).  The layout is the reference's: q (B, Hq, Sq,
D), k and v (B, Hkv, Skv, D).  The reference's ``block_q``/``block_k``
tiling options have no counterpart: the kernels' tiles are fixed.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.device import resolve_impl
from .kernel import HEAD_DIMS, flash_attention_bwd_cuda, flash_attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Attention forward with GQA, causal masking, a sliding window
    (``window`` > 0: query i sees keys j with i - j < window), tanh softcap
    and a ``kv_len`` bound on the keys; -> q's shape and dtype."""
    if resolve_impl(impl, q) == "torch":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, sm_scale=sm_scale,
                             kv_len=kv_len)
    D, Skv = q.shape[-1], k.shape[2]
    sm_scale = D ** -0.5 if sm_scale is None else float(sm_scale)
    kv_len = Skv if kv_len is None else int(kv_len)
    # the kernels are built for HEAD_DIMS: a narrower head (the smoke
    # configs' 16 and 32) runs zero-padded to the next one, where the zero
    # columns add nothing to q k^T and give zero output columns, cut off
    pad = min((d for d in HEAD_DIMS if d >= D), default=D) - D
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    o, _ = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, bool(causal), int(window), float(softcap), sm_scale,
        kv_len)
    return o[..., :D] if pad else o


# ---------------------------------------------------------------------------
# kernel 10 and its backward as registered operators
# ---------------------------------------------------------------------------

def visible_pairs(Sq: int, Skv: int, *, causal: bool, window: int,
                  kv_len: int) -> int:
    """The (query, key) pairs ``ref.visibility`` lets attention see: query i
    sees key j when j < kv_len, i >= j (causal) and i - j < window
    (window > 0), summed row by row."""
    n = 0
    kv_len = min(kv_len, Skv)
    for i in range(Sq):
        hi = min(i, kv_len - 1) if causal else kv_len - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def attention_flops(q_shape, k_shape, *, causal: bool, window: int,
                    kv_len: int, backward: bool = False) -> int:
    """Kernel 10's multiply-adds x 2 over the visible pairs: the forward's
    two products (q k^T and p v), 4 B Hq pairs D; the backward's five (the
    scores recomputed, dp = do v^T, dv, dq and dk), 10 B Hq pairs D."""
    B, Hq, Sq, D = q_shape
    pairs = visible_pairs(Sq, k_shape[2], causal=causal, window=window,
                          kv_len=kv_len)
    return (10 if backward else 4) * B * Hq * pairs * D


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _kernel_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, softcap: float, sm_scale: float,
                kv_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, sm_scale=sm_scale,
                                kv_len=kv_len, lse=True)


@_kernel_fwd.register_fake
def _(q, k, v, causal, window, softcap, sm_scale, kv_len):
    B, Hq, Sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, Hq, Sq),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _kernel_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                causal: bool, window: int, softcap: float, sm_scale: float,
                kv_len: int) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    return flash_attention_bwd_cuda(q, k, v, o, lse, do.contiguous(),
                                    causal=causal, window=window,
                                    softcap=softcap, sm_scale=sm_scale,
                                    kv_len=kv_len)


@_kernel_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window, softcap, sm_scale, kv_len):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _kernel_setup(ctx, inputs, output):
    q, k, v, causal, window, softcap, sm_scale, kv_len = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.kw = (causal, window, softcap, sm_scale, kv_len)


def _kernel_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _kernel_bwd(q, k, v, o, lse, do, *ctx.kw)
    return dq, dk, dv, None, None, None, None, None


_kernel_fwd.register_autograd(_kernel_backward, setup_context=_kernel_setup)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
    def _fwd_flops(q, k, v, causal, window, softcap, sm_scale, kv_len, *,
                   out_shape=None, **kw):
        return attention_flops(q, k, causal=causal, window=window,
                               kv_len=kv_len)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _bwd_flops(q, k, v, o, lse, do, causal, window, softcap, sm_scale,
                   kv_len, *, out_shape=None, **kw):
        return attention_flops(q, k, causal=causal, window=window,
                               kv_len=kv_len, backward=True)


_register_flops()

