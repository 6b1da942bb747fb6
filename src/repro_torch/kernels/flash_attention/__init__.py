"""Blocked online-softmax attention (kernel 10) and its backward: the
hand-written kernels for CUDA tensors, ``attention_ref`` (with its
autograd) for CPU tensors (see ``ops``); ``chunked`` holds the reference's
plain XLA schedule."""
from .chunked import attention_chunked
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ops import attention_flops, flash_attention
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["attention_bwd_ref", "attention_chunked", "attention_flops",
           "attention_lse_ref", "attention_ref", "flash_attention",
           "flash_attention_bwd_cuda", "flash_attention_cuda"]
