"""Pytrees in JAX's flatten order.

Nested dicts (keys sorted), lists, tuples and NamedTuples in order, a
``SlabGraph``'s tensors in ``FIELDS`` order, ``None`` an empty subtree, and
anything else a leaf.  The order is a format: ``checkpoint.ckpt`` numbers
its leaves by it, so either package restores the other's checkpoints, and
the optimizer, the train steps and the gradient collectives walk parameter
trees by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

from .slab_graph import FIELDS, SlabGraph


def flatten(tree, path: str = "") -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(path, leaf), ...], rebuild)``: the leaves in JAX's flatten
    order and a function that rebuilds the structure from an iterator of
    new leaves."""
    if tree is None:
        return [], lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k], f"{path}/{k}") for k in keys]

        def rebuild(it):
            return {k: fn(it) for k, (_, fn) in zip(keys, parts)}
        return [x for leaves, _ in parts for x in leaves], rebuild
    if isinstance(tree, SlabGraph):
        parts = [flatten(getattr(tree, f), f"{path}/{f}") for f in FIELDS]

        def rebuild(it):
            return dataclasses.replace(
                tree, **{f: fn(it) for f, (_, fn) in zip(FIELDS, parts)})
        return [x for leaves, _ in parts for x in leaves], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [flatten(x, f"{path}/{i}") for i, x in enumerate(tree)]

        def rebuild(it):
            items = [fn(it) for _, fn in parts]
            if isinstance(tree, list):
                return items
            return type(tree)(*items) if hasattr(tree, "_fields") \
                else tuple(items)
        return [x for leaves, _ in parts for x in leaves], rebuild
    return [(path, tree)], lambda it: next(it)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    return [x for _, x in flatten(tree)[0]]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with ``leaves`` (an iterable, in
    ``tree_leaves`` order) in place of its leaves."""
    return flatten(like)[1](iter(leaves))


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in
                                 zip(tree_leaves(tree), *others)])
