"""Sharding rules, from ``repro.distributed.sharding``: one table from
logical activation and parameter names to specs, applied through a context
the models consult.

Axes convention (``launch.mesh``):

* single pod: ``("data", "model")``, 16 x 16;
* multi pod: ``("pod", "data", "model")``, 2 x 16 x 16; ``"pod"`` composes
  with ``"data"`` for batch-like dims: ``("pod", "data")``.

Models call ``constrain(x, "<name>")`` at the few points that matter (the
residual stream between layers, the logits, the MoE dispatch buffers, the
node and edge tables).  Outside a rules context, or on a plain tensor, it
is the identity, so every path on one device runs as it did.  Inside one,
on a ``DTensor``, it redistributes the tensor to the rule's placements.

PyTorch has no ``PartitionSpec``: ``P`` is a small spec type of mesh-axis
names per tensor dim (``None``, one name or a tuple of names), and
``placements`` is its one converter to DTensor placements.  A dim split
over several axes, ``P(("data", "model"))``, becomes ``[Shard(0),
Shard(0)]`` on a ``("data", "model")`` mesh: DTensor splits over the mesh
dims left to right, so ``"data"`` is the major split, as in JAX.  The
names of a dim must follow the mesh's axis order (``ValueError``
otherwise).

Unlike the reference's ``constrain`` (which rejects ``jax.make_mesh``'s
Explicit axes), this one takes any ``DeviceMesh`` whose dims are named.

The dynamic-graph plane uses its own flat ``("shard",)`` mesh
(``distributed.ranks.SHARD_AXIS``): the rules never mention ``"shard"``,
and the graph plane never mentions ``"data"`` or ``"model"``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import torch

_CTX: dict = {"mesh": None, "rules": None}

Axis = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A spec: one entry per tensor dim, each ``None`` (not split), a mesh
    axis name, or a tuple of names (split over those axes, major first).
    Trailing dims past the spec's length are not split, as in JAX."""

    def __new__(cls, *dims: Axis):
        return super().__new__(cls, tuple(
            tuple(d) if isinstance(d, list) else d for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split tensor dim ``dim``."""
        d = self[dim] if dim < len(self) else None
        if d is None:
            return ()
        return (d,) if isinstance(d, str) else tuple(d)


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return tuple(names)


def placements(mesh, spec: Optional[P]) -> list:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``:
    ``Shard(d)`` on each mesh dim that splits tensor dim ``d``,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim in range(len(spec or ())):
        axes = spec.axes(dim)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} lists its axes "
                             f"{axes} out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[i]!r} "
                                 "twice")
            out[i] = Shard(dim)
    return out


def dp_axes(mesh) -> Tuple[str, ...]:
    """The batch-like axes for this mesh: ("pod", "data") or ("data",)."""
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def default_rules(mesh) -> Dict[str, P]:
    dp = dp_axes(mesh)
    return {
        # LM activations
        "act_btd": P(dp, None, None),        # (B, S, D)
        "act_btd_tp": P(dp, None, "model"),  # big models: shard D (carry)
        "logits": P(dp, None, "model"),
        "moe_ecd": P("model", None, None),   # (E, C, D) expert buffers
        "moe_tokens_g": P(dp, None, None),   # (G, Tg, D) grouped dispatch
        "moe_gecd": P(dp, "model", None, None),  # (G, E, C, D) buffers
        "tokens": P(dp, None),
        # LM params
        "embed": P("model", None),           # (V, D)
        "attn_in": P(None, None, "model"),   # (L, D, H*hd)
        "attn_out": P(None, "model", None),  # (L, H*hd, D)
        "mlp_in": P(None, None, "model"),    # (L, D, F)
        "mlp_out": P(None, "model", None),   # (L, F, D)
        "moe_expert_in": P(None, "model", None, None),   # (L, E, D, F)
        "moe_expert_out": P(None, "model", None, None),  # (L, E, F, D)
        "lm_head": P(None, "model"),
        # decode caches
        "cache_heads": P(None, dp, "model", None, None),   # (L,B,H,S,hd)
        "cache_seq": P(None, dp, None, "model", None),
        "cache_seq_dp": P(None, None, None, dp + ("model",), None),
        # GNN / recsys
        "nodes": P(dp + ("model",)),          # (N, ...) node tables
        "gnn_h_rows": P(dp + ("model",), None, None),  # (N, C, 2l+1) irreps
        "edges_chunked": P(None, dp + ("model",)),     # (K, blk) edge chunks
        "edges_chunked_h": P(None, dp + ("model",), None),
        "nodes_feat": P(dp, "model"),
        "edges": P(dp + ("model",)),          # (E,) edge tables
        "embed_rows": P(dp + ("model",), None),  # huge embedding tables
        "batch": P(dp),
    }


@contextlib.contextmanager
def sharding_rules(mesh, overrides: Optional[Dict[str, P]] = None):
    """Within the context, ``constrain`` applies ``default_rules(mesh)``
    updated by ``overrides``; the previous context comes back on exit, an
    exception's included."""
    rules = default_rules(mesh)
    if overrides:
        rules.update(overrides)
    prev = dict(_CTX)
    _CTX["mesh"] = mesh
    _CTX["rules"] = rules
    try:
        yield rules
    finally:
        _CTX.update(prev)


class _GradTo(torch.autograd.Function):
    """Identity whose backward lays the gradient out as ``placements``: a
    sharding constraint's transpose is the same constraint on the
    cotangent, as in JAX."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Replicate
        # a pending sum's gradient is replicated
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != list(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def constrain(x, name: str):
    """Apply the named sharding constraint: a ``DTensor`` redistributed to
    the rule's placements inside a rules context (its gradient too, as
    JAX transposes ``with_sharding_constraint``); the identity outside
    one, for a name without a rule, or on a plain tensor."""
    mesh, rules = _CTX["mesh"], _CTX["rules"]
    if mesh is None or rules is None or name not in rules:
        return x
    spec = rules[name]
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, spec)
    if list(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradTo.apply(x, tuple(want))
    return x


def named(mesh, spec: P) -> list:
    """The placements of ``spec`` on ``mesh`` (the reference returns a
    ``NamedSharding``, the pair of the two)."""
    return placements(mesh, spec)


def spec_or_none(name: str) -> Optional[P]:
    rules = _CTX["rules"]
    return None if rules is None else rules.get(name)


def fit_heads(x, n_heads: int):
    """``x`` (..., H * hd), a projection about to be split into ``n_heads``
    heads, or an attention's heads merged back: a DTensor whose last dim is
    split over mesh axes that do not divide ``n_heads`` gets those axes
    replicated (a split there would cut a head), its gradient too.
    Anything else comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh, last = x.device_mesh, x.dim() - 1
    want, n = list(x.placements), 1
    for i, p in enumerate(want):
        if isinstance(p, Shard) and p.dim in (last, -1):
            n *= mesh.size(i)
            if n_heads % n:
                want[i] = Replicate()
    if want != list(x.placements):
        x = x.redistribute(mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradTo.apply(x, tuple(want))
    return x


def fsdp_gather(w):
    """A parameter as a layer uses it: ZeRO-3's weight all-gather, the
    splits of a DTensor over the batch-like axes (``dp_axes``) replicated
    and its 'model' splits kept (``lm_param_specs``' posture: parameters
    and optimizer state sharded over the whole mesh, weights gathered a
    layer at a time).  Anything else comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    names, dp = _axis_names(mesh), dp_axes(mesh)
    want = [Replicate() if names[i] in dp else p
            for i, p in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(mesh, want)


def local_heads(fn, q, k, v):
    """``fn(q, k, v)``, an attention over q (B, Hq, S, D) and k, v (B, Hkv,
    S, D).  On DTensors it runs on each device's block, as GSPMD lays an
    attention out: the batch split over the batch-like axes (when they
    divide it), the heads over 'model' (when it divides both head counts),
    every other axis replicated; the output keeps that layout.  Plain
    tensors go straight to ``fn``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    names, dp = _axis_names(mesh), dp_axes(mesh)
    n_dp = 1
    for i, name in enumerate(names):
        if name in dp:
            n_dp *= mesh.size(i)
    layout = []
    for i, name in enumerate(names):
        n = mesh.size(i)
        if name in dp and q.shape[0] % n_dp == 0:
            layout.append(Shard(0))
        elif name == "model" and q.shape[1] % n == 0 and k.shape[1] % n == 0:
            layout.append(Shard(1))
        else:
            layout.append(Replicate())
    q, k, v = (t.redistribute(mesh, layout) for t in (q, k, v))
    return local_map(fn, out_placements=layout,
                     in_placements=(layout, layout, layout),
                     device_mesh=mesh)(q, k, v)


def stacked_like(buf: torch.Tensor, item):
    """``buf`` (n, *item.shape), a buffer a loop fills one ``item`` at a
    time: a DTensor laid out as ``item`` along the trailing dims when
    ``item`` is one (so the writes move nothing), else ``buf``."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    if not isinstance(item, DTensor):
        return buf
    want = [Shard(p.dim + 1) if isinstance(p, Shard) else p
            for p in item.placements]
    return distribute_tensor(buf, item.device_mesh, want,
                             src_data_rank=None)


def distribute(x: torch.Tensor, mesh, spec: Optional[P]):
    """``x`` as a DTensor on ``mesh`` laid out by ``spec`` (``None``:
    replicated): each device keeps its own block, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(mesh, spec or P()),
                             src_data_rank=None)


__all__ = ["P", "placements", "dp_axes", "default_rules", "sharding_rules",
           "constrain", "named", "spec_or_none", "fit_heads", "fsdp_gather",
           "local_heads", "stacked_like", "distribute"]
