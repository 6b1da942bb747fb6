"""Device and implementation selection, shared by every entry point.

Entry points take an explicit ``device`` and run on ``cuda`` unless the
caller passes ``device="cpu"``.  A request for ``cuda`` on a machine without
a card raises: nothing carries on on the CPU behind the caller's back.

Kernel implementations follow the tensors: ``impl="auto"`` is ``"cuda"``
(the hand-written kernels) for tensors on the card and ``"torch"`` (their
plain versions) for tensors on the CPU.  An explicit choice that contradicts
where the tensors lie raises.
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "cuda", "torch")


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises for ``cuda`` without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """``"cuda"`` or ``"torch"`` for tensor ``t``, validating ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    want = "cuda" if t.is_cuda else "torch"
    if impl not in ("auto", want):
        raise ValueError(f"impl={impl!r} does not match tensors on "
                         f"{t.device}; the kernels run on CUDA tensors and "
                         "their plain versions on CPU tensors")
    return want
