"""Matrix-product flop counts on both sides of a parity test.

``jaxpr_dot_flops`` counts the ``dot_general``s of a reference jaxpr: 2 x
the lhs's size x the rhs's free size, nested jaxprs included, a scan's
body times its length, by the lhs's dtype.  ``MatmulFlops`` counts the
same for the port's operators, by ``FlopCounterMode``'s formulas, keyed by
the first operand's dtype.
"""
from __future__ import annotations

import math
from typing import Dict

import jax.extend as jex
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


def _sub_jaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, jex.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex.core.Jaxpr):
                yield x


def jaxpr_dot_flops_by_dtype(jaxpr, mult: int = 1,
                             out: Dict[str, int] = None) -> Dict[str, int]:
    """{lhs dtype name: flops} over every ``dot_general`` of ``jaxpr``."""
    out = {} if out is None else out
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, rc), (_, rb) = eqn.params["dimension_numbers"]
            lhs, rhs = eqn.invars[0].aval, eqn.invars[1].aval
            free = math.prod(d for i, d in enumerate(rhs.shape)
                             if i not in rc and i not in rb)
            key = str(lhs.dtype)
            out[key] = out.get(key, 0) + mult * 2 * math.prod(lhs.shape) \
                * free
        inner = mult * (eqn.params["length"]
                        if eqn.primitive.name == "scan" else 1)
        assert eqn.primitive.name not in ("while", "cond"), eqn.primitive
        for sub in _sub_jaxprs(eqn.params):
            jaxpr_dot_flops_by_dtype(sub, inner, out)
    return out


def jaxpr_dot_flops(jaxpr) -> int:
    """The total of ``jaxpr_dot_flops_by_dtype``."""
    return sum(jaxpr_dot_flops_by_dtype(jaxpr).values())


class MatmulFlops(TorchDispatchMode):
    """``by_dtype``: {first operand's dtype name: flops} over the operators
    that ``FlopCounterMode`` has a formula for."""

    def __init__(self):
        super().__init__()
        self.by_dtype: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            first = next(a for a in pytree.tree_leaves(args)
                         if isinstance(a, torch.Tensor))
            shapes = pytree.tree_map(
                lambda x: x.shape if isinstance(x, torch.Tensor) else x,
                (args, kwargs, out))
            key = str(first.dtype).replace("torch.", "")
            self.by_dtype[key] = self.by_dtype.get(key, 0) + int(
                formula(*shapes[0], **shapes[1], out_val=shapes[2]))
        return out
