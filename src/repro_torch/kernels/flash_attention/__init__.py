"""Blocked online-softmax attention (kernel 10): the hand-written kernel for
CUDA tensors, ``attention_ref`` for CPU tensors (see ``ops``)."""
from .kernel import flash_attention_cuda
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_cuda"]
